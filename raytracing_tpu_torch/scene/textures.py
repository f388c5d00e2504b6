"""Texture evaluation over integer texture ids, the counterpart of
``raytracing_tpu.scene.textures``. A checker's value at a point is its
even or odd child's value there, so checker ids are first rewritten to
their parity-selected child (``CHECKER_NEST_DEPTH`` rounds); then only
the leaf types (solid, image, marble noise) are evaluated, all of them,
and selected by type.
"""
from __future__ import annotations

import torch

from . import perlin as perlin_mod
from .types import CHECKER_NEST_DEPTH, TEX_CHECKER, TEX_IMAGE, TEX_NOISE, Scene

# the value of an image texture whose image is missing
CYAN = (0.0, 1.0, 1.0)


def resolve_checker(scene: Scene, tex_id: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rewrite checker ids to their parity-selected child: cell =
    floor(inv_scale·p) per axis, even iff the cells' sum is even (Python's
    remainder, so negative sums keep their parity). Other ids pass."""
    tex = scene.textures
    for _ in range(CHECKER_NEST_DEPTH):
        tid = tex_id.long()
        is_checker = tex.ttype[tid] == TEX_CHECKER
        cells = torch.floor(tex.scale[tid][..., None] * p).to(torch.int32)
        is_even = (cells.sum(-1, dtype=torch.int32) % 2) == 0
        child = torch.where(is_even, tex.child[tid, 0], tex.child[tid, 1])
        tex_id = torch.where(is_checker, child, tex_id)
    return tex_id


def _image_value(scene: Scene, tex_id: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Texel at (u, v): clamp u, flip v, then nearest-texel truncation or,
    with ``flags.image_bilinear``, bilinear filtering (continuous in
    (u, v), so geometry gradients flow through it)."""
    atlas = scene.atlas
    img = scene.textures.image_id[tex_id.long()].long()
    h = atlas.sizes[img, 0]
    w = atlas.sizes[img, 1]
    uu = torch.clamp(u, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v, 0.0, 1.0)
    hm, wm = (h - 1).clamp(min=0).long(), (w - 1).clamp(min=0).long()
    zero = torch.zeros_like(hm)
    if scene.flags.image_bilinear:
        x = uu * w.to(u.dtype) - 0.5
        y = vv * h.to(u.dtype) - 0.5
        x0f = torch.floor(x)
        y0f = torch.floor(y)
        fx = (x - x0f)[..., None]
        fy = (y - y0f)[..., None]
        x0 = torch.clamp(x0f.long(), zero, wm)
        x1 = torch.clamp(x0 + 1, zero, wm)
        y0 = torch.clamp(y0f.long(), zero, hm)
        y1 = torch.clamp(y0 + 1, zero, hm)
        t00 = atlas.texels[img, y0, x0]
        t01 = atlas.texels[img, y0, x1]
        t10 = atlas.texels[img, y1, x0]
        t11 = atlas.texels[img, y1, x1]
        texel = (1 - fy) * ((1 - fx) * t00 + fx * t01) + fy * ((1 - fx) * t10 + fx * t11)
    else:
        i = torch.clamp((uu * w.to(u.dtype)).to(torch.int32).long(), zero, wm)
        j = torch.clamp((vv * h.to(u.dtype)).to(torch.int32).long(), zero, hm)
        texel = atlas.texels[img, j, i]
    # filled on the device (no host copy), so a captured CUDA graph can run it
    cyan = torch.stack([texel.new_full((), c) for c in CYAN])
    return torch.where((h > 0)[..., None], texel, cyan)


def eval_texture(scene: Scene, tex_id: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 p: torch.Tensor) -> torch.Tensor:
    """Colour (B, 3) of texture ``tex_id`` (B,) at surface coordinates
    (u, v) (B,) and hit point p (B, 3). Branches no texture of the scene
    uses are skipped by its flags."""
    tex = scene.textures
    flags = scene.flags
    if flags.has_checker:
        tex_id = resolve_checker(scene, tex_id, p)
    tid = tex_id.long()
    ttype = tex.ttype[tid]
    out = tex.rgb[tid]  # solid colour, the default
    if flags.has_image:
        out = torch.where((ttype == TEX_IMAGE)[..., None], _image_value(scene, tex_id, u, v), out)
    if flags.has_noise:
        m = perlin_mod.marble(scene.perlin, p, tex.scale[tid])
        out = torch.where((ttype == TEX_NOISE)[..., None], m[..., None].expand_as(out), out)
    return out
