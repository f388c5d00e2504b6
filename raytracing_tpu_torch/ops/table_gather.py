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

The backward is the gather's scatter-add, ``index_add_`` of the ``(F, B)``
cotangent into an ``(L, F)`` zero table. (The JAX package writes it as a
one-hot matmul because scatter is serial on a TPU.) On CUDA
``index_add_`` adds with atomics in a run-dependent order, so two
backward passes agree to float32 reassociation, not bit for bit.
"""
from __future__ import annotations

import torch

launches = 0  # K4 kernel launches in this process (plain-version calls excluded)


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
    from .. import _kernels

    lib = _kernels.library().lib
    global launches
    with torch.cuda.device(dev):
        err = lib.rt_table_gather(table.data_ptr(), ids.data_ptr(), L, F, B, out.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    if err != 0:
        raise RuntimeError(f"K4 launch failed: {lib.rt_error_string(err).decode()}")
    return out


class _TableLookup(torch.autograd.Function):
    """K4 forward, ``index_add_`` backward."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.L = table.shape[0]
        return gather(table, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        tbar = torch.zeros((ctx.L, g.shape[0]), dtype=g.dtype, device=g.device)
        tbar.index_add_(0, ids.clamp(0, ctx.L - 1).long(), g.t())
        return tbar, None


def table_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (L, F) at ``ids`` (B,) i32, clipped into range
    (callers mask invalid lanes downstream), as one ``(F, B)`` tensor;
    differentiable in ``table``. Unbind it for the per-field columns."""
    return _TableLookup.apply(table.contiguous(), ids.to(torch.int32).contiguous())
