"""The packed replay table: the counterpart of the table half of
``raytracing_tpu.diff.replay_fast``.

Every per-primitive quantity the replay's bounce math reads is packed
into one ``(L, N_FIELDS)`` f32 table, one row per global scene id
(spheres, then quads), built with autograd from the scene's tensors: a
cotangent on the table flows back to sphere centers, velocities and
radii, quad corners and edges, material fuzz and ior, and texture rgbs.
The replay kernels (``diff/replay_kernel.py``) read the rows of the
recorded winner ids. (``replay_trace_fast`` itself, which gathers rows
through the TPU's K4 lane gather, is not ported yet.)
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.intersect import quad_plane_basis
from ..scene.types import MAT_DIELECTRIC, TEX_CHECKER, TEX_SOLID, Scene

# packed field slots
_F_ISQUAD = 0
_F_G0 = 1      # center | q          (3)
_F_G1 = 4      # velocity | u edge   (3)
_F_RAD = 7     # radius | 0
_F_QN = 8      # 0 | unit normal     (3)
_F_QD = 11     # 0 | plane D
_F_MTYPE = 12
_F_FUZZ = 13
_F_IOR = 14    # 1.0 for non-dielectrics (keeps masked branches finite)
_F_ISCHK = 15
_F_RGB_E = 16  # even-child / solid rgb (3)
_F_RGB_O = 19  # odd-child rgb          (3)
_F_INVSC = 22  # checker inv_scale
N_FIELDS = 23


def supported_fast(scene: Scene) -> bool:
    """The replay covers solid and one-level checker-of-solids textures."""
    tt = scene.textures.ttype.detach().cpu().numpy()
    if not np.all((tt == TEX_SOLID) | (tt == TEX_CHECKER)):
        return False
    kids = scene.textures.child.detach().cpu().numpy()[tt == TEX_CHECKER].reshape(-1)
    return bool(np.all(tt[kids] == TEX_SOLID)) if kids.size else True


def table_rows(n_primitives: int) -> int:
    """L: rows of the packed table, the primitives padded to a multiple of 128."""
    return max(128, -(-n_primitives // 128) * 128)


def build_replay_table(scene: Scene) -> torch.Tensor:
    """``(L, N_FIELDS)`` f32 packed per-global-primitive table on the
    scene's device, differentiable in the scene's float tensors. Padding
    rows are zero except ior = 1."""
    sph, qd = scene.spheres, scene.quads
    mats, tex = scene.materials, scene.textures
    n_sph, n_quad = scene.n_spheres, scene.n_quads
    n = n_sph + n_quad
    dev = sph.center.device
    f32 = torch.float32

    def mat_cols(mat_id):
        mat_id = mat_id.long()
        mt = mats.mtype[mat_id]
        ior = torch.where(mt == MAT_DIELECTRIC, mats.ior[mat_id], 1.0)
        tid = mats.tex_id[mat_id].long()
        is_chk = tex.ttype[tid] == TEX_CHECKER
        even = torch.where(is_chk, tex.child[tid, 0].long(), tid)
        odd = torch.where(is_chk, tex.child[tid, 1].long(), tid)
        return [mt.to(f32)[:, None], mats.fuzz[mat_id][:, None], ior[:, None],
                is_chk.to(f32)[:, None], tex.rgb[even], tex.rgb[odd],
                torch.where(is_chk, tex.scale[tid], 0.0)[:, None]]

    def zeros(m, k):
        return torch.zeros((m, k), dtype=f32, device=dev)

    rows_s = torch.cat([zeros(n_sph, 1), sph.center, sph.velocity, sph.radius[:, None],
                        zeros(n_sph, 4), *mat_cols(sph.mat_id)], dim=1)
    parts = [rows_s]
    if n_quad > 0:
        normal, dconst = quad_plane_basis(qd)
        parts.append(torch.cat([torch.ones((n_quad, 1), dtype=f32, device=dev), qd.q, qd.u,
                                zeros(n_quad, 1), normal, dconst[:, None],
                                *mat_cols(qd.mat_id)], dim=1))
    pad = zeros(table_rows(n) - n, N_FIELDS)
    pad[:, _F_IOR] = 1.0  # keeps masked dielectric math finite
    parts.append(pad)
    return torch.cat(parts, dim=0)
