"""Material shading of a batch of hits: emission and scatter, the
counterpart of ``raytracing_tpu.ops.scatter``. Every material's response
is computed for every ray and selected by the material tag; the three
stochastic decisions (lambertian's degenerate direction, metal's absorb
below the surface, the dielectric's Fresnel coin) are masks driven by the
counter-based RNG.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import rng as rng_mod
from ..core import vecmath as vm
from ..scene.textures import eval_texture
from ..scene.types import MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_METAL, Scene
from .intersect import HitBatch


@dataclass
class ScatterBatch:
    direction: torch.Tensor    # (B, 3) scattered ray direction
    attenuation: torch.Tensor  # (B, 3) throughput multiplier
    emitted: torch.Tensor      # (B, 3) emitted radiance at the hit
    did_scatter: torch.Tensor  # (B,) bool; False: the path is absorbed


def schlick_reflectance(cosine: torch.Tensor, ref_idx: torch.Tensor) -> torch.Tensor:
    """Schlick's r0 + (1 - r0)(1 - cos θ)^5, the fifth power as
    x·((x·x)·(x·x)), the order of the JAX package's integer power."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))


def scatter_and_emit(scene: Scene, d_in: torch.Tensor, hit: HitBatch,
                     uniforms: torch.Tensor) -> ScatterBatch:
    """Scatter and emission at ``hit`` for incoming directions ``d_in``
    (B, 3), from this bounce's draws ``uniforms`` (B, 4)."""
    mats = scene.materials
    mid = hit.mat_id.long()
    mtype = mats.mtype[mid]
    n = hit.normal

    # lambertian and metal albedo, the dielectric's white, or emission
    tex_val = eval_texture(scene, mats.tex_id[mid], hit.u, hit.v, hit.p)
    ruv = rng_mod.unit_vector(uniforms[:, :2])  # shared unit-sphere sample

    # lambertian: n + random unit vector; a degenerate sum falls back to n
    lam_dir = n + ruv
    lam_dir = torch.where(vm.near_zero(lam_dir)[:, None], n, lam_dir)

    # metal: unit(reflect) + fuzz·ruv, absorbed below the surface
    reflected = vm.normalize(vm.reflect(d_in, n)) + mats.fuzz[mid][:, None] * ruv
    metal_ok = vm.dot(reflected, n) > 0.0

    # dielectric: reflect or refract by the Fresnel coin
    ior = mats.ior[mid]
    ri = torch.where(hit.front_face, 1.0 / ior, ior)
    unit_d = vm.normalize(d_in)
    cos_theta = torch.clamp(vm.dot(-unit_d, n), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = ri * sin_theta > 1.0
    reflect_coin = schlick_reflectance(cos_theta, ri) > uniforms[:, 2]
    use_reflect = cannot_refract | reflect_coin
    diel_dir = torch.where(use_reflect[:, None], vm.reflect(unit_d, n),
                           vm.refract(unit_d, n, ri))

    is_metal = mtype == MAT_METAL
    is_diel = mtype == MAT_DIELECTRIC
    is_light = mtype == MAT_DIFFUSE_LIGHT
    direction = torch.where(is_metal[:, None], reflected, lam_dir)
    direction = torch.where(is_diel[:, None], diel_dir, direction)
    attenuation = torch.where(is_diel[:, None], torch.ones_like(tex_val), tex_val)
    emitted = torch.where(is_light[:, None], tex_val, torch.zeros_like(tex_val))
    did_scatter = torch.where(is_metal, metal_ok, torch.ones_like(metal_ok)) & ~is_light
    return ScatterBatch(direction=direction, attenuation=attenuation, emitted=emitted,
                        did_scatter=did_scatter)
