"""A scene as plain tables, built by the published recipes in
``benchmark/configs/<name>.py``.

The rows come in the order the recipe adds them, as the renderer's
``SceneBuilder`` lays them out, so that gradients with respect to sphere
centres (one row a sphere) and texture colours (one row a texture) line
up with the program's row for row. Textures: a solid colour, or a 3-D checker of
two solid children whose ``scale`` holds the inverse of the recipe's cell
size. Materials: lambertian, metal (fuzz clamped to 1), dielectric (a
white texture row of its own) and diffuse light. A box is six quads.
"""
from __future__ import annotations

import numpy as np

LAMBERTIAN, METAL, DIELECTRIC, LIGHT = 0, 1, 2, 3
SOLID, CHECKER = 0, 1


class SceneTables:
    def __init__(self):
        self.tex_type, self.tex_rgb, self.tex_scale, self.tex_child = [], [], [], []
        self.mat_type, self.mat_tex, self.mat_fuzz, self.mat_ior = [], [], [], []
        self.sph_center, self.sph_velocity, self.sph_radius, self.sph_mat = [], [], [], []
        self.quad_q, self.quad_u, self.quad_v, self.quad_mat = [], [], [], []

    def _tex(self, ttype, rgb=(0.0, 0.0, 0.0), scale=1.0, child=(0, 0)):
        self.tex_type.append(ttype)
        self.tex_rgb.append(np.asarray(rgb, np.float32))
        self.tex_scale.append(np.float32(scale))
        self.tex_child.append(tuple(child))
        return len(self.tex_type) - 1

    def solid(self, rgb):
        return self._tex(SOLID, rgb=rgb)

    def checker(self, cell, even_rgb, odd_rgb):
        even, odd = self.solid(even_rgb), self.solid(odd_rgb)
        return self._tex(CHECKER, scale=1.0 / cell, child=(even, odd))

    def _mat(self, mtype, tex, fuzz=0.0, ior=1.0):
        self.mat_type.append(mtype)
        self.mat_tex.append(tex)
        self.mat_fuzz.append(np.float32(fuzz))
        self.mat_ior.append(np.float32(ior))
        return len(self.mat_type) - 1

    def lambertian(self, tex_or_rgb):
        tex = tex_or_rgb if isinstance(tex_or_rgb, int) else self.solid(tex_or_rgb)
        return self._mat(LAMBERTIAN, tex)

    def metal(self, rgb, fuzz):
        return self._mat(METAL, self.solid(rgb), fuzz=min(float(fuzz), 1.0))

    def dielectric(self, ior):
        return self._mat(DIELECTRIC, self.solid((1.0, 1.0, 1.0)), ior=ior)

    def light(self, rgb):
        return self._mat(LIGHT, self.solid(rgb))

    def sphere(self, center, radius, mat, center2=None):
        c = np.asarray(center, np.float32)
        self.sph_center.append(c)
        self.sph_velocity.append(np.zeros(3, np.float32) if center2 is None
                                 else np.asarray(center2, np.float32) - c)
        self.sph_radius.append(np.float32(radius))
        self.sph_mat.append(mat)

    def quad(self, q, u, v, mat):
        for lst, x in ((self.quad_q, q), (self.quad_u, u), (self.quad_v, v)):
            lst.append(np.asarray(x, np.float32))
        self.quad_mat.append(mat)

    def box(self, a, b, mat):
        mn = np.minimum(np.asarray(a, np.float32), np.asarray(b, np.float32))
        mx = np.maximum(np.asarray(a, np.float32), np.asarray(b, np.float32))
        dx = np.array([mx[0] - mn[0], 0, 0], np.float32)
        dy = np.array([0, mx[1] - mn[1], 0], np.float32)
        dz = np.array([0, 0, mx[2] - mn[2]], np.float32)
        self.quad([mn[0], mn[1], mx[2]], dx, dy, mat)   # front
        self.quad([mx[0], mn[1], mx[2]], -dz, dy, mat)  # right
        self.quad([mx[0], mn[1], mn[2]], -dx, dy, mat)  # back
        self.quad([mn[0], mn[1], mn[2]], dz, dy, mat)   # left
        self.quad([mn[0], mx[1], mx[2]], dx, -dz, mat)  # top
        self.quad([mn[0], mn[1], mn[2]], dx, dz, mat)   # bottom

    def arrays(self) -> dict:
        """Every table as a numpy array (float32 or int64)."""
        f3 = lambda rows: np.asarray(rows, np.float32).reshape(-1, 3)  # noqa: E731
        return dict(
            tex_type=np.asarray(self.tex_type, np.int64), tex_rgb=f3(self.tex_rgb),
            tex_scale=np.asarray(self.tex_scale, np.float32),
            tex_child=np.asarray(self.tex_child, np.int64).reshape(-1, 2),
            mat_type=np.asarray(self.mat_type, np.int64),
            mat_tex=np.asarray(self.mat_tex, np.int64),
            mat_fuzz=np.asarray(self.mat_fuzz, np.float32),
            mat_ior=np.asarray(self.mat_ior, np.float32),
            sph_center=f3(self.sph_center), sph_velocity=f3(self.sph_velocity),
            sph_radius=np.asarray(self.sph_radius, np.float32),
            sph_mat=np.asarray(self.sph_mat, np.int64),
            quad_q=f3(self.quad_q), quad_u=f3(self.quad_u), quad_v=f3(self.quad_v),
            quad_mat=np.asarray(self.quad_mat, np.int64))
