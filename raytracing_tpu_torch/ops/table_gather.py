"""Differentiable per-ray table lookup, the counterpart of
``raytracing_tpu.ops.table_gather``.

``table_lookup(table (L, F) f32, ids (B,) i32)`` clips the ids into
``[0, L - 1]`` and returns the rows, field-major as ``(F, B)``: field f of
every ray is the contiguous row ``out[f]``. Its forward is **K4**
(:func:`gather`), a hand-written CUDA kernel (``csrc/table_gather.cu``)
that replaces the Pallas ``_pallas_gather``; the plain PyTorch version
beside it, :func:`gather_torch`, is ``index_select`` and a transpose.
Tensors on the CPU run the plain version; tensors on a CUDA device launch
the kernel, or raise. Each launch adds one to :data:`launches`.

The backward is the gather's scatter-add, :func:`fold`: the ``(F, B)``
cotangent summed into an ``(L, F)`` zero table at the clipped ids. (The
JAX package writes it as a one-hot matmul because scatter is serial on a
TPU.) On CUDA tensors it is a hand-written kernel too (``rt_table_fold``
in ``csrc/table_gather.cu``), whose plain version, :func:`fold_torch`, is
``index_add_``; its batched form folds a whole ``(D, F, n)`` stack of
per-bounce cotangents over per-bounce ray prefixes, the replay's table
reduction (``diff/replay_kernel.reduce_table_grads``), in one launch per
window of at most :data:`FOLD_MAX_D` bounces (:func:`fold_windows`).
Both add in a run-dependent order on the card (atomics), so two backward
passes agree to float32 reassociation, not bit for bit. Each fold launch
adds one to :data:`fold_launches`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _kernels

launches = _kernels.LaunchCount()       # K4 kernel launches (plain-version calls excluded)
fold_launches = _kernels.LaunchCount()  # fold kernel launches (plain-version calls excluded)
FOLD_MAX_D = 64    # bounces of one fold launch, a window (csrc/table_gather.cu FOLD_MAX_D)
FOLD_MAX_F = 32    # fields a folded row may have


def gather_torch(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain K4: ``(F, B)`` rows of ``table`` at ``ids`` clipped into range."""
    return table.index_select(0, ids.clamp(0, table.shape[0] - 1)).t()


def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K4: ``(F, B)`` f32, ``out[f, i] = table[clip(ids[i], 0, L-1), f]``.
    ``table (L, F)`` f32 and ``ids (B,)`` i32 on one device."""
    if table.dim() != 2 or table.dtype != torch.float32 or table.shape[0] < 1:
        raise ValueError(f"table must be (L, F) float32 with L >= 1, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be (B,) int32, got {tuple(ids.shape)} {ids.dtype}")
    dev = table.device
    if ids.device != dev:
        raise ValueError("table and ids must be on one device")
    if dev.type == "cpu":
        return gather_torch(table, ids)
    if dev.type != "cuda":
        raise ValueError(f"K4 runs on CUDA tensors (kernel) or CPU tensors (plain version), "
                         f"not {dev}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("K4 needs contiguous tensors")
    L, F = table.shape
    B = ids.shape[0]
    if L * F >= 2 ** 31 or F * B >= 2 ** 31:
        raise ValueError(f"K4 lookup of {B} rays × {F} fields exceeds its 32-bit indexing")
    out = torch.empty((F, B), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = _kernels.library().lib
    with torch.cuda.device(dev):
        err = lib.rt_table_gather(table.data_ptr(), ids.data_ptr(), L, F, B, out.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
    launches.add(dev)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: {lib.rt_error_string(err).decode()}")
    return out


def _prefix_list(prefixes, D, n):
    return [n] * D if prefixes is None else [min(n, max(0, int(p))) for p in prefixes]


def fold_windows(D: int, prefixes) -> list:
    """The fold's launches for ``D`` bounces with per-bounce ray
    ``prefixes`` (D ints): ``[(w0, prefixes[w0:w1]), ...]`` for the windows
    ``[w0, w1)`` of at most :data:`FOLD_MAX_D` consecutive bounces, in
    order, leaving out a window whose prefixes are all 0 (it adds
    nothing)."""
    P = [int(x) for x in prefixes]
    if len(P) != D:
        raise ValueError(f"one prefix per bounce: {D} bounces, {len(P)} prefixes")
    return [(w0, P[w0:w0 + FOLD_MAX_D]) for w0 in range(0, D, FOLD_MAX_D)
            if any(P[w0:w0 + FOLD_MAX_D])]


def fold_torch(g: torch.Tensor, ids: torch.Tensor, L: int, prefixes=None) -> torch.Tensor:
    """Plain fold: ``index_add_`` of each bounce's ``g[b, :, :P_b]`` into an
    ``(L, F)`` zero table at rows ``clip(ids[b, :P_b], 0, L - 1)``."""
    D, F, n = g.shape
    acc = torch.zeros((L, F), dtype=g.dtype, device=g.device)
    for b, P in enumerate(_prefix_list(prefixes, D, n)):
        if P > 0:
            acc.index_add_(0, ids[b, :P].clamp(0, L - 1).long(), g[b, :, :P].T)
    return acc


def fold(g: torch.Tensor, ids: torch.Tensor, L: int, prefixes=None) -> torch.Tensor:
    """The table fold: ``tbar (L, F)`` f32 with ``tbar[clip(ids[b, i], 0,
    L-1), f] += g[b, f, i]`` for every bounce ``b`` and ray ``i <
    prefixes[b]`` (every ray when ``prefixes`` is None). ``g (D, F, n)``
    f32 and ``ids (D, n)`` i32, or ``(F, n)`` and ``(n,)`` for one bounce.
    On CUDA the result is a view of an ``(L, F)`` table padded to a
    multiple of 4 columns, summed by one launch per window of
    :func:`fold_windows`, each adding into it."""
    if g.dim() == 2:
        g, ids = g[None], ids[None]
    if g.dim() != 3 or g.dtype != torch.float32:
        raise ValueError(f"g must be (D, F, n) float32, got {tuple(g.shape)} {g.dtype}")
    D, F, n = g.shape
    if ids.shape != (D, n) or ids.dtype != torch.int32:
        raise ValueError(f"ids must be ({D}, {n}) int32, got {tuple(ids.shape)} {ids.dtype}")
    if L < 1 or (prefixes is not None and len(prefixes) != D):
        raise ValueError(f"fold needs L >= 1 and one prefix per bounce, got L={L}, "
                         f"{None if prefixes is None else len(prefixes)} prefixes for {D}")
    dev = g.device
    if ids.device != dev:
        raise ValueError("g and ids must be on one device")
    if dev.type == "cpu":
        return fold_torch(g, ids, L, prefixes)
    if dev.type != "cuda":
        raise ValueError(f"the fold runs on CUDA tensors (kernel) or CPU tensors (plain "
                         f"version), not {dev}")
    if F > FOLD_MAX_F:
        raise ValueError(f"the fold takes at most {FOLD_MAX_F} fields, got {F}")
    if L * F >= 2 ** 31 or min(D, FOLD_MAX_D) * n >= 2 ** 31:
        raise ValueError(f"fold of {min(D, FOLD_MAX_D)} x {n} rays a launch into {L} rows "
                         f"exceeds its 32-bit indexing")
    g, ids = g.contiguous(), ids.contiguous()
    fp = -(-F // 4) * 4
    out = torch.zeros((L, fp), dtype=torch.float32, device=dev)
    windows = fold_windows(D, _prefix_list(prefixes, D, n))
    if F == 0 or not windows:
        return out[:, :F]
    lib = _kernels.library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for w0, P in windows:
            dw = len(P)
            err = lib.rt_table_fold(g[w0:w0 + dw].data_ptr(), ids[w0:w0 + dw].data_ptr(),
                                    (ctypes.c_int * dw)(*P), L, F, n, dw, out.data_ptr(), stream)
            fold_launches.add(dev)
            if err != 0:
                raise RuntimeError(f"fold launch failed: {lib.rt_error_string(err).decode()}")
    return out[:, :F]


class _TableLookup(torch.autograd.Function):
    """K4 forward, fold backward."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.L = table.shape[0]
        return gather(table, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return fold(g.contiguous(), ids, ctx.L), None


def table_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (L, F) at ``ids`` (B,) i32, clipped into range
    (callers mask invalid lanes downstream), as one ``(F, B)`` tensor;
    differentiable in ``table``. Unbind it for the per-field columns."""
    return _TableLookup.apply(table.contiguous(), ids.to(torch.int32).contiguous())
