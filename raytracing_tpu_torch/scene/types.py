"""Struct-of-arrays scene schema: dataclasses of tensors, the counterpart
of ``raytracing_tpu.scene.types`` (which uses ``flax.struct``).

Geometry is flat per-primitive columns (spheres, quads); materials and
textures are integer-tagged parameter tables; the Perlin tables feed the
marble texture. The tags and the field
layout are the JAX package's, so a scene converts between the two field
by field (scene/convert.py). Participating media (:class:`Media`,
The Next Week's ``constant_medium``) are the port's own: the JAX package
has none, and only K1 traces them (:func:`refuse_media`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

# Material type tags
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4  # a medium's phase function: a uniform direction, albedo as attenuation

# Texture type tags
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3  # marble noise

# levels of checker-of-checker nesting the texture evaluation resolves
CHECKER_NEST_DEPTH = 2


@dataclass
class Spheres:
    """Static and moving spheres. ``center`` is the t=0 center and
    ``velocity`` the offset per unit time. Padded rows have radius 0."""
    center: torch.Tensor    # (N, 3) f32
    velocity: torch.Tensor  # (N, 3) f32
    radius: torch.Tensor    # (N,)  f32
    mat_id: torch.Tensor    # (N,)  i32


@dataclass
class Quads:
    """Parallelograms Q + s·u + t·v, s, t ∈ [0, 1]. Padded rows have
    u = v = 0."""
    q: torch.Tensor       # (M, 3) f32
    u: torch.Tensor       # (M, 3) f32
    v: torch.Tensor       # (M, 3) f32
    mat_id: torch.Tensor  # (M,)  i32


@dataclass
class Media:
    """Constant-density media, each bounded by a sphere that is not itself
    a primitive (a boundary that should also refract is added as a
    dielectric sphere beside it). ``mat_id`` is an ``MAT_ISOTROPIC`` row
    with a solid albedo."""
    center: torch.Tensor   # (M, 3) f32
    radius: torch.Tensor   # (M,)  f32
    density: torch.Tensor  # (M,)  f32, per unit length
    mat_id: torch.Tensor   # (M,)  i32


@dataclass
class Materials:
    mtype: torch.Tensor   # (K,) i32, MAT_* tag
    tex_id: torch.Tensor  # (K,) i32, albedo (or emission) texture
    fuzz: torch.Tensor    # (K,) f32, metal fuzz radius
    ior: torch.Tensor     # (K,) f32, dielectric refraction index


@dataclass
class Textures:
    ttype: torch.Tensor     # (T,) i32, TEX_* tag
    rgb: torch.Tensor       # (T, 3) f32, solid color
    scale: torch.Tensor     # (T,) f32, checker inv_scale or noise scale
    child: torch.Tensor     # (T, 2) i32, checker (even, odd) texture ids
    image_id: torch.Tensor  # (T,) i32, index into the image atlas


@dataclass
class ImageAtlas:
    """Image texels stacked and padded to the largest (H, W); ``sizes``
    holds each image's true (height, width)."""
    texels: torch.Tensor  # (n_img, Hmax, Wmax, 3) f32
    sizes: torch.Tensor   # (n_img, 2) i32


@dataclass
class PerlinTables:
    """Perlin noise tables: 256 unit gradient vectors and three
    permutations, drawn on the host from a seeded numpy generator
    (scene/perlin.py ``make_tables``)."""
    randvec: torch.Tensor  # (256, 3) f32
    perm_x: torch.Tensor   # (256,) i32
    perm_y: torch.Tensor   # (256,) i32
    perm_z: torch.Tensor   # (256,) i32


@dataclass
class BVH:
    """Flattened binary BVH in depth-first preorder with skip links, the
    integrator's acceleration structure (ops/bvh.py builds it on the host,
    ops/traverse.py walks it). For node ``i``: if ``prim[i] >= 0`` it is a
    leaf over that primitive (global primitive index: spheres first, then
    quads). Otherwise its first child is ``i + 1`` and ``miss[i]`` is the
    next node to visit when the subtree is skipped (-1 ends the walk)."""
    bbox_min: torch.Tensor  # (K, 3) f32
    bbox_max: torch.Tensor  # (K, 3) f32
    prim: torch.Tensor      # (K,) i32, leaf primitive id or -1
    miss: torch.Tensor      # (K,) i32, skip link or -1


class SceneFlags(NamedTuple):
    """Facts about a compiled scene that let the renderer skip work."""
    has_checker: bool = True
    has_image: bool = True
    has_noise: bool = True
    has_moving: bool = True  # any sphere with nonzero velocity
    image_bilinear: bool = False


@dataclass
class Scene:
    """A compiled scene: geometry, materials, textures, noise tables, the
    integrator's BVH (None when compiled without one; the megakernels build
    their own chunked BVH and never read it) and flags."""
    spheres: Spheres
    quads: Quads
    materials: Materials
    textures: Textures
    atlas: ImageAtlas
    perlin: PerlinTables
    bvh: Optional[BVH] = None
    flags: SceneFlags = SceneFlags()
    media: Optional[Media] = None

    @property
    def n_spheres(self) -> int:
        return self.spheres.radius.shape[0]

    @property
    def n_quads(self) -> int:
        return self.quads.mat_id.shape[0]

    @property
    def n_primitives(self) -> int:
        return self.n_spheres + self.n_quads

    @property
    def n_media(self) -> int:
        return 0 if self.media is None else self.media.radius.shape[0]


def refuse_media(scene: "Scene", what: str) -> None:
    """Raise ValueError when ``scene`` holds participating media, which
    only K1 traces (the megakernel's block layout, phased schedule):
    ``what`` names the path that would render the scene without them."""
    if scene.n_media:
        raise ValueError(f"{what} does not trace participating media, and this scene has "
                         f"{scene.n_media} (constant_medium): render it through "
                         f"Renderer(hit_method='auto' or 'mega'), schedule='phased'")


def float_leaves(obj, path=()):
    """``(path, tensor)`` of every floating-point tensor in a dataclass tree
    (a :class:`Scene`, ``CameraParams``), depth first in field order."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if torch.is_tensor(v):
            if v.is_floating_point():
                yield path + (f.name,), v
        elif dataclasses.is_dataclass(v):
            yield from float_leaves(v, path + (f.name,))


def with_leaves(obj, leaves: dict, path=()):
    """A copy of the dataclass tree ``obj`` with the tensors at ``leaves``'
    paths replaced."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        p = path + (f.name,)
        if p in leaves:
            changes[f.name] = leaves[p]
        elif dataclasses.is_dataclass(v):
            changes[f.name] = with_leaves(v, leaves, p)
    return dataclasses.replace(obj, **changes)
