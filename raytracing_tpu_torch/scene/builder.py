"""Host-side scene construction (NumPy) and compilation to a tensor
:class:`Scene`: the counterpart of ``raytracing_tpu.scene.builder``.

The builder API and the compiled row layout are the JAX package's, so
both packages build identical tables from the same calls, the integrator's
BVH (``compile(use_bvh=True)``, ops/bvh.py) included. The megakernels do
not read that BVH: they build their own chunked BVH from the compiled
tables (ops/mega_bvh.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve
from ..ops.bvh import build_bvh
from ..utils.profiling import annotate
from . import assets, perlin
from .types import (
    BVH,
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_ISOTROPIC,
    MAT_LAMBERTIAN,
    MAT_METAL,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
    TEX_SOLID,
    ImageAtlas,
    Materials,
    Media,
    Quads,
    Scene,
    SceneFlags,
    Spheres,
    Textures,
)

Color = Union[Tuple[float, float, float], Sequence[float], np.ndarray]

# media a scene may hold: each draws its free path from one lane of the
# PCG4D draw of stream STREAM_MEDIUM (core/rng.py), which has four
MAX_MEDIA = 4


def _pad_to(n: int, multiple: int) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


@dataclass
class SceneBuilder:
    """Imperative scene construction. ``add``-style methods return integer
    ids; :meth:`compile` produces the :class:`Scene`."""
    tex_type: List[int] = field(default_factory=list)
    tex_rgb: List[np.ndarray] = field(default_factory=list)
    tex_scale: List[float] = field(default_factory=list)
    tex_child: List[Tuple[int, int]] = field(default_factory=list)
    tex_image: List[int] = field(default_factory=list)
    images: List[np.ndarray] = field(default_factory=list)
    mat_type: List[int] = field(default_factory=list)
    mat_tex: List[int] = field(default_factory=list)
    mat_fuzz: List[float] = field(default_factory=list)
    mat_ior: List[float] = field(default_factory=list)
    sph_center: List[np.ndarray] = field(default_factory=list)
    sph_velocity: List[np.ndarray] = field(default_factory=list)
    sph_radius: List[float] = field(default_factory=list)
    sph_mat: List[int] = field(default_factory=list)
    quad_q: List[np.ndarray] = field(default_factory=list)
    quad_u: List[np.ndarray] = field(default_factory=list)
    quad_v: List[np.ndarray] = field(default_factory=list)
    quad_mat: List[int] = field(default_factory=list)
    med_center: List[np.ndarray] = field(default_factory=list)
    med_radius: List[float] = field(default_factory=list)
    med_density: List[float] = field(default_factory=list)
    med_mat: List[int] = field(default_factory=list)

    # ----------------------------- textures ------------------------------
    def _add_texture_row(self, ttype, rgb=(0, 0, 0), scale=1.0, child=(0, 0), image=-1) -> int:
        self.tex_type.append(ttype)
        self.tex_rgb.append(np.asarray(rgb, np.float32))
        self.tex_scale.append(float(scale))
        self.tex_child.append((int(child[0]), int(child[1])))
        self.tex_image.append(int(image))
        return len(self.tex_type) - 1

    def solid(self, rgb: Color) -> int:
        return self._add_texture_row(TEX_SOLID, rgb=rgb)

    def checker(self, scale: float, even: Union[int, Color], odd: Union[int, Color]) -> int:
        """3-D spatial checker of two sub-textures; ``even``/``odd`` are
        texture ids or RGB colors."""
        even_id = even if isinstance(even, int) else self.solid(even)
        odd_id = odd if isinstance(odd, int) else self.solid(odd)
        return self._add_texture_row(TEX_CHECKER, scale=1.0 / scale, child=(even_id, odd_id))

    def image(self, source: Union[str, np.ndarray]) -> int:
        """Image texture from a file name (probed and decoded by
        ``assets.load_image``) or an (H, W, 3) float array in [0, 1]."""
        arr = (assets.load_image(source) if isinstance(source, str)
               else np.asarray(source, np.float32))
        self.images.append(arr)
        return self._add_texture_row(TEX_IMAGE, image=len(self.images) - 1)

    def noise(self, scale: float) -> int:
        """Marble noise texture."""
        return self._add_texture_row(TEX_NOISE, scale=scale)

    def _as_tex(self, tex_or_rgb: Union[int, Color]) -> int:
        return tex_or_rgb if isinstance(tex_or_rgb, int) else self.solid(tex_or_rgb)

    # ----------------------------- materials -----------------------------
    def _add_material_row(self, mtype, tex, fuzz=0.0, ior=1.0) -> int:
        self.mat_type.append(mtype)
        self.mat_tex.append(tex)
        self.mat_fuzz.append(float(fuzz))
        self.mat_ior.append(float(ior))
        return len(self.mat_type) - 1

    def lambertian(self, tex_or_rgb: Union[int, Color]) -> int:
        return self._add_material_row(MAT_LAMBERTIAN, self._as_tex(tex_or_rgb))

    def metal(self, rgb: Color, fuzz: float) -> int:
        """Fuzzy mirror; fuzz is clamped to <= 1."""
        return self._add_material_row(MAT_METAL, self.solid(rgb), fuzz=min(float(fuzz), 1.0))

    def dielectric(self, refraction_index: float) -> int:
        return self._add_material_row(MAT_DIELECTRIC, self.solid((1.0, 1.0, 1.0)), ior=refraction_index)

    def diffuse_light(self, tex_or_rgb: Union[int, Color]) -> int:
        return self._add_material_row(MAT_DIFFUSE_LIGHT, self._as_tex(tex_or_rgb))

    def isotropic(self, albedo: Color) -> int:
        """A medium's phase function: it scatters into a uniform direction
        with ``albedo`` as attenuation. Only :meth:`constant_medium` takes
        it; a surface refuses it."""
        return self._add_material_row(MAT_ISOTROPIC, self.solid(albedo))

    def _surface(self, mat: int) -> int:
        if 0 <= mat < len(self.mat_type) and self.mat_type[mat] == MAT_ISOTROPIC:
            raise ValueError("an isotropic material is a medium's phase function: give it to "
                             "constant_medium, not to a surface")
        return mat

    # ----------------------------- geometry ------------------------------
    def sphere(self, center: Color, radius: float, mat: int, center2: Optional[Color] = None) -> int:
        """Static sphere, or a moving one that travels center → center2
        over t ∈ [0, 1]."""
        c = np.asarray(center, np.float32)
        self.sph_center.append(c)
        vel = np.zeros(3, np.float32) if center2 is None else np.asarray(center2, np.float32) - c
        self.sph_velocity.append(vel)
        self.sph_radius.append(float(radius))
        self.sph_mat.append(self._surface(mat))
        return len(self.sph_radius) - 1

    def quad(self, q: Color, u: Color, v: Color, mat: int) -> int:
        self.quad_q.append(np.asarray(q, np.float32))
        self.quad_u.append(np.asarray(u, np.float32))
        self.quad_v.append(np.asarray(v, np.float32))
        self.quad_mat.append(self._surface(mat))
        return len(self.quad_mat) - 1

    def constant_medium(self, center: Color, radius: float, density: float,
                        albedo: Union[int, Color]) -> int:
        """A constant-density medium inside the sphere (``center``,
        ``radius``), The Next Week's ``constant_medium``: a ray crossing
        it scatters after a free path of -ln(u)/density, isotropically,
        with ``albedo`` (a color, or an :meth:`isotropic` material) as
        attenuation. The boundary is not a surface: add a sphere of its
        own for one. Returns the medium's index."""
        if self.n_media >= MAX_MEDIA:
            raise ValueError(f"a scene holds at most {MAX_MEDIA} media")
        if not (radius > 0 and density >= 0):
            raise ValueError(f"a medium needs radius > 0 and density >= 0, got {radius}, "
                             f"{density}")
        mat = albedo if isinstance(albedo, int) else self.isotropic(albedo)
        if self.mat_type[mat] != MAT_ISOTROPIC or self.tex_type[self.mat_tex[mat]] != TEX_SOLID:
            raise ValueError("a medium's material must be isotropic() with a solid albedo")
        self.med_center.append(np.asarray(center, np.float32))
        self.med_radius.append(float(radius))
        self.med_density.append(float(density))
        self.med_mat.append(mat)
        return self.n_media - 1

    def box(self, a: Color, b: Color, mat: int) -> None:
        """Axis-aligned box as 6 quads from two opposite corners."""
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        mn = np.minimum(a, b)
        mx = np.maximum(a, b)
        dx = np.array([mx[0] - mn[0], 0, 0], np.float32)
        dy = np.array([0, mx[1] - mn[1], 0], np.float32)
        dz = np.array([0, 0, mx[2] - mn[2]], np.float32)
        self.quad([mn[0], mn[1], mx[2]], dx, dy, mat)    # front
        self.quad([mx[0], mn[1], mx[2]], -dz, dy, mat)   # right
        self.quad([mx[0], mn[1], mn[2]], -dx, dy, mat)   # back
        self.quad([mn[0], mn[1], mn[2]], dz, dy, mat)    # left
        self.quad([mn[0], mx[1], mx[2]], dx, -dz, mat)   # top
        self.quad([mn[0], mn[1], mn[2]], dx, dz, mat)    # bottom

    def translate(self, offset: Color):
        """Primitives and media added inside ``with b.translate(offset):``
        are shifted by ``offset`` (sphere and medium centers, quad corners;
        nestable)."""
        return _TranslateScope(self, np.asarray(offset, np.float32))

    # ----------------------------- compile -------------------------------
    @property
    def n_spheres(self) -> int:
        return len(self.sph_radius)

    @property
    def n_quads(self) -> int:
        return len(self.quad_mat)

    @property
    def n_media(self) -> int:
        return len(self.med_radius)

    def compile(self, device=DEFAULT_DEVICE, perlin_seed: int = 0,
                image_bilinear: bool = False, use_bvh: bool = True) -> Scene:
        """Lower the builder state to a :class:`Scene` on ``device`` (default:
        the card; raises without CUDA unless ``device="cpu"``).
        Primitive tables are padded to a multiple of 8 rows with inert
        entries (zero-radius spheres, degenerate quads); the Perlin tables
        are drawn from ``perlin_seed``. With ``use_bvh`` the integrator's
        BVH is built on the host over the *real* primitives, indexing the
        padded global id space (spheres first, then quads at offset
        n_sphere_rows); media are kept out of it. With the port's tracing
        switch on (``utils.profiling``) the compile is the span
        ``rt.scene.compile``."""
        with annotate("rt.scene.compile"):
            return self._compile(resolve(device), perlin_seed, image_bilinear, use_bvh)

    def _compile(self, device, perlin_seed: int, image_bilinear: bool, use_bvh: bool) -> Scene:
        n_sph = _pad_to(max(self.n_spheres, 1), 8)
        n_quad = _pad_to(max(self.n_quads, 1), 8)

        def stack(rows, pad_rows, shape, dtype=np.float32):
            out = np.zeros((pad_rows, *shape), dtype)
            if rows:
                out[: len(rows)] = np.asarray(rows, dtype)
            return torch.from_numpy(out).to(device)

        def col(values, dtype):
            return torch.from_numpy(np.asarray(values, dtype)).to(device)

        spheres = Spheres(
            center=stack(self.sph_center, n_sph, (3,)),
            velocity=stack(self.sph_velocity, n_sph, (3,)),
            radius=stack(self.sph_radius, n_sph, ()),
            mat_id=stack(self.sph_mat, n_sph, (), np.int32),
        )
        quads = Quads(
            q=stack(self.quad_q, n_quad, (3,)),
            u=stack(self.quad_u, n_quad, (3,)),
            v=stack(self.quad_v, n_quad, (3,)),
            mat_id=stack(self.quad_mat, n_quad, (), np.int32),
        )
        if not self.mat_type:  # a scene must have at least one material row
            self.lambertian((0.5, 0.5, 0.5))
        materials = Materials(
            mtype=col(self.mat_type, np.int32),
            tex_id=col(self.mat_tex, np.int32),
            fuzz=col(self.mat_fuzz, np.float32),
            ior=col(self.mat_ior, np.float32),
        )
        textures = Textures(
            ttype=col(self.tex_type, np.int32),
            rgb=torch.from_numpy(np.stack(self.tex_rgb)).to(device),
            scale=col(self.tex_scale, np.float32),
            child=col(self.tex_child, np.int32),
            image_id=col(self.tex_image, np.int32),
        )
        if self.images:
            hmax = max(im.shape[0] for im in self.images)
            wmax = max(im.shape[1] for im in self.images)
            texels = np.zeros((len(self.images), hmax, wmax, 3), np.float32)
            sizes = np.zeros((len(self.images), 2), np.int32)
            for k, im in enumerate(self.images):
                texels[k, : im.shape[0], : im.shape[1]] = im
                sizes[k] = (im.shape[0], im.shape[1])
        else:
            texels = np.zeros((1, 1, 1, 3), np.float32)
            sizes = np.zeros((1, 2), np.int32)
        atlas = ImageAtlas(texels=torch.from_numpy(texels).to(device),
                           sizes=torch.from_numpy(sizes).to(device))
        flags = SceneFlags(
            has_checker=any(t == TEX_CHECKER for t in self.tex_type),
            has_image=any(t == TEX_IMAGE for t in self.tex_type),
            has_noise=any(t == TEX_NOISE for t in self.tex_type),
            has_moving=any(np.any(v != 0) for v in self.sph_velocity),
            image_bilinear=image_bilinear,
        )
        bvh = None
        if use_bvh and (self.n_spheres + self.n_quads) > 0:
            flat = build_bvh(
                sphere_center=np.asarray(self.sph_center, np.float32).reshape(-1, 3),
                sphere_velocity=np.asarray(self.sph_velocity, np.float32).reshape(-1, 3),
                sphere_radius=np.asarray(self.sph_radius, np.float32),
                quad_q=np.asarray(self.quad_q, np.float32).reshape(-1, 3),
                quad_u=np.asarray(self.quad_u, np.float32).reshape(-1, 3),
                quad_v=np.asarray(self.quad_v, np.float32).reshape(-1, 3),
                quad_id_offset=n_sph,
            )
            bvh = BVH(bbox_min=torch.from_numpy(flat.bbox_min).to(device),
                      bbox_max=torch.from_numpy(flat.bbox_max).to(device),
                      prim=torch.from_numpy(flat.prim).to(device),
                      miss=torch.from_numpy(flat.miss).to(device))
        media = None
        if self.med_radius:
            media = Media(center=torch.from_numpy(np.stack(self.med_center)).to(device),
                          radius=col(self.med_radius, np.float32),
                          density=col(self.med_density, np.float32),
                          mat_id=col(self.med_mat, np.int32))
        return Scene(spheres=spheres, quads=quads, materials=materials,
                     textures=textures, atlas=atlas,
                     perlin=perlin.make_tables(perlin_seed, device), bvh=bvh, flags=flags,
                     media=media)


class _TranslateScope:
    """Context manager behind :meth:`SceneBuilder.translate`: offsets every
    primitive added inside the scope when it exits."""

    def __init__(self, builder: SceneBuilder, offset: np.ndarray):
        self.builder = builder
        self.offset = offset

    def __enter__(self):
        self._s0 = self.builder.n_spheres
        self._q0 = self.builder.n_quads
        self._m0 = self.builder.n_media
        return self.builder

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        b = self.builder
        for i in range(self._s0, b.n_spheres):
            b.sph_center[i] = b.sph_center[i] + self.offset
        for j in range(self._q0, b.n_quads):
            b.quad_q[j] = b.quad_q[j] + self.offset
        for k in range(self._m0, b.n_media):
            b.med_center[k] = b.med_center[k] + self.offset
        return False
