"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit) and the bytes the port's bytes-bound kernels need,
each input read once and each output written once, from their shapes.

K2 (``k2_replay_bwd``) launches once a chunk of ``B`` rays at depth
``D``: it writes the ``(D, NG, B)`` float32 cotangents and reads each
ray's ``N_RAY_F`` floats, its two RNG ids, its three radiance cotangents
and its tile's length bound, every recorded winner id (one a segment) and
the ``(L, N_FIELDS)`` table. The fold (``k4_table_fold``) reads the
``NG`` cotangents and the id of each ray-bounce in the planned prefixes
and writes the ``(L, NG)`` table cotangent.
"""
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

NG = 19         # differentiable table fields K2 writes a cotangent for
N_RAY_F = 8     # floats a ray carries into the replay
N_FIELDS = 23   # fields of a table row
TILE = 1024     # rays per gating tile; prefixes are multiples of it


def pad8(n: int) -> int:
    return max(8, -(-max(n, 1) // 8) * 8)


def table_rows(spheres: int, quads: int) -> int:
    """L: the replay table's rows, the padded primitives rounded up to 128."""
    n = pad8(spheres) + pad8(quads)
    return max(128, -(-n // 128) * 128)


def k2_bytes(B: int, D: int, segments: int, L: int) -> int:
    """Bytes one K2 launch needs; ``segments``: the chunk's recorded winners."""
    return B * (N_RAY_F * 4 + 8 + 12 + 4) + 4 * segments + 4 * L * N_FIELDS + 4 * D * NG * B


def fold_bytes(fold_rays: int, L: int) -> int:
    """Bytes one fold launch needs over ``fold_rays`` ray-bounces."""
    return 4 * (fold_rays * (NG + 1) + L * NG)


def share_pct(nbytes: float, seconds: float):
    """The bytes bound's time over the measured ``seconds``, in percent;
    None when nothing was measured."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * (nbytes / PEAK_BYTES_PER_S) / seconds
