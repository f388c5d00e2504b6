"""Build port objects from plain arrays keyed by field path.

``scene_from_arrays`` takes a dict of numpy arrays keyed by the field
paths of ``raytracing_tpu``'s ``Scene`` (``"spheres.center"``,
``"textures.child"``, ``"atlas.sizes"``, ...) and returns a port
:class:`Scene`; ``camera_params_from_arrays`` does the same for
``CameraParams``. With them a scene built by either package computes on
the same parameters in the other. The integrator's BVH (``bvh.*``) comes
across when its keys are present; without them the scene has none.
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve
from ..render.camera import CameraParams
from .types import (
    BVH,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
    ImageAtlas,
    Materials,
    PerlinTables,
    Quads,
    Scene,
    SceneFlags,
    Spheres,
    Textures,
)

_GROUPS = {"spheres": Spheres, "quads": Quads, "materials": Materials,
           "textures": Textures, "atlas": ImageAtlas, "perlin": PerlinTables}


def scene_from_arrays(d: dict, device=DEFAULT_DEVICE, image_bilinear: bool = False) -> Scene:
    """``{"spheres.center": array, ...}`` → :class:`Scene` on ``device``.
    The flags are derived from the arrays."""
    device = resolve(device)
    parts = {}
    for group, cls in _GROUPS.items():
        parts[group] = cls(**{
            f.name: torch.from_numpy(np.array(d[f"{group}.{f.name}"])).to(device)
            for f in fields(cls)})
    ttype = np.asarray(d["textures.ttype"])
    flags = SceneFlags(
        has_checker=bool(np.any(ttype == TEX_CHECKER)),
        has_image=bool(np.any(ttype == TEX_IMAGE)),
        has_noise=bool(np.any(ttype == TEX_NOISE)),
        has_moving=bool(np.any(np.asarray(d["spheres.velocity"]) != 0)),
        image_bilinear=image_bilinear,
    )
    bvh = None
    if "bvh.prim" in d:
        bvh = BVH(**{f.name: torch.from_numpy(np.array(d[f"bvh.{f.name}"])).to(device)
                     for f in fields(BVH)})
    return Scene(**parts, bvh=bvh, flags=flags)


def camera_params_from_arrays(d: dict, device=DEFAULT_DEVICE) -> CameraParams:
    """``{"lookfrom": (3,), ..., "focus_dist": ()}`` → :class:`CameraParams`."""
    device = resolve(device)
    return CameraParams(**{
        f.name: torch.tensor(np.asarray(d[f.name], np.float32), device=device)
        for f in fields(CameraParams)})
