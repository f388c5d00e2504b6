"""Chunk programs replayed as CUDA graphs: the port's single dispatch.

The JAX package renders (and sweeps gradients over) every chunk inside one
jitted ``fori_loop`` (``raytracing_tpu/render/renderer.py`` ``_get_fused``,
``bench.py`` ``bench_fwd_bwd(fused=True)``): jit traces the loop once and
the device runs it without the host. PyTorch issues every op of a chunk
from Python, a few hundred a chunk, so here one chunk's ops are captured
once as a CUDA graph and the graph is replayed once a chunk.

A :class:`ChunkProgram` runs a ``step(counter)`` that reads and writes
only static buffers (its ``state``): the chunk it traces comes from a
device counter that the program increments after it, and its results are
added into device accumulators, so no replay needs an argument or a host
read. On the CPU the same step runs eagerly once a chunk, which is how the
CPU tests hold its arithmetic against the loop it replaces.
:func:`over_chunks` drives one step function either way: as a Python loop
over int chunk indices (``fused=False``) or as a program's replays.

The kernels' launch counts (``_kernels.LaunchCount``) are device counters
that each wrapper adds to on its launch stream, so a replay adds the
launches it runs, as an eager launch does.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Optional

import torch


class ChunkProgram:
    """``step(counter)``: one chunk of work on static buffers ``state``,
    the chunk being the one the 0-d int64 device tensor ``counter`` holds.
    :meth:`run` runs chunks in order, adding one to the counter after
    each: on a card as replays of one captured CUDA graph, on the CPU
    eagerly."""

    def __init__(self, step: Callable[[torch.Tensor], None], device, state: dict):
        self.step = step
        self.device = torch.device(device)
        self.state = state
        self.counter = torch.zeros((), dtype=torch.int64, device=self.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_seconds = 0.0  # warm-up and capture, once

    def _step(self) -> None:
        self.step(self.counter)
        self.counter.add_(1)

    def run(self, first: int, n: int, init: Callable[[], None]) -> float:
        """Chunks ``first`` to ``first + n - 1`` after ``init()`` sets the
        state. On a card the first run with chunks to run captures: it
        runs ``init()`` and one warm-up step on a side stream (as
        ``torch.cuda.graph`` requires), then captures one step; it returns
        the seconds that took, which a caller's timing leaves out (0.0
        otherwise). Capture errors propagate: there is no eager
        fallback."""
        def start():
            init()
            self.counter.fill_(first)

        spent = 0.0
        if self.device.type == "cuda" and self.graph is None and n > 0:
            spent = self._capture(start)
        start()
        self.replay(n)
        return spent

    def _capture(self, start: Callable[[], None]) -> float:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            start()
            self._step()
        current.wait_stream(side)
        # A dead program in a reference cycle (its step holds its owner)
        # that Python's cycle collector frees mid-capture destroys its
        # graph then, and that invalidates this capture: collect now, and
        # keep the collector off until the capture has ended.
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._step()
        finally:
            if enabled:
                gc.enable()
        self.graph = graph
        torch.cuda.synchronize(self.device)
        # the warm-up's blocks go back to the card: a program holds its
        # graph's pool, not that pool and the eager one's cache as well
        torch.cuda.empty_cache()
        self.capture_seconds = time.perf_counter() - t0
        return self.capture_seconds

    def replay(self, n: int) -> None:
        """``n`` more chunks from the counter as it stands, with no host
        synchronization between them."""
        if n == 0:
            return
        if self.device.type != "cuda":
            for _ in range(n):
                self._step()
            return
        if self.graph is None:
            raise RuntimeError("ChunkProgram.replay before its capture on a CUDA device")
        for _ in range(n):
            self.graph.replay()


class ProgramSlot:
    """One chunk program at a time: a new key drops the old program (and
    its graph's memory pool) before the new one is built."""

    def __init__(self):
        self.key = None
        self.program: Optional[ChunkProgram] = None

    def get(self, key, make: Callable[[], ChunkProgram]) -> ChunkProgram:
        if self.program is None or self.key != key:
            self.key = self.program = None
            self.program = make()
            self.key = key
        return self.program


def _owned(v):
    """A copy of ``v`` (a tensor, or a dataclass of them) with buffers of
    its own: a program copies new inputs into its state, and must never
    copy them into a caller's tensors (a camera derived from params may
    hold them)."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    return dataclasses.replace(v, **{f.name: getattr(v, f.name).clone()
                                     for f in dataclasses.fields(v)})


def _assign(dst, src) -> None:
    """Copy ``src`` into ``dst`` in place: tensors, or dataclasses of them."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for f in dataclasses.fields(dst):
            getattr(dst, f.name).copy_(getattr(src, f.name))


def over_chunks(slot: ProgramSlot, key, make_state: Callable[[], dict],
                step: Callable[[object, dict], None], first: int, n: int, device,
                fused: bool):
    """``step(c, state)`` for chunks ``c = first .. first + n - 1`` on a
    state that starts as ``make_state()`` (a dict of tensors and of
    dataclasses of tensors). Returns ``(state, seconds of a capture made
    by this call)``.

    ``fused=False``: a Python loop on a new state, ``c`` an int.
    ``fused``: the replays of ``slot``'s program for ``key`` (built on a
    state of its own when the key is new, which captures on a card), ``c``
    its counter, a 0-d int64 device tensor; ``make_state()``'s values are
    copied into the program's state first, so new inputs need no new
    capture. The step must give the same results for either ``c``."""
    if not fused:
        state = make_state()
        for c in range(first, first + n):
            step(c, state)
        return state, 0.0

    def make():
        state = {k: _owned(v) for k, v in make_state().items()}
        return ChunkProgram(lambda counter: step(counter, state), device, state)

    prog = slot.get(key, make)

    def init():
        for k, v in make_state().items():
            _assign(prog.state[k], v)

    return prog.state, prog.run(first, n, init)


def histogram(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``torch.bincount(x, minlength=n_bins)`` for integers in ``[0,
    n_bins)``, as a scatter-add into ``n_bins`` int64 bins: CUDA's
    ``bincount`` reads the input's extremes back to the host, which a
    captured graph cannot. Integer adds are exact in any order."""
    x = x.reshape(-1).to(torch.int64)
    return torch.zeros(n_bins, dtype=torch.int64, device=x.device).index_add_(
        0, x, torch.ones_like(x))


def to_host(*tensors: torch.Tensor) -> list:
    """The tensors as numpy arrays through one device-to-host copy: their
    bytes concatenated on the device, copied once, split on the host."""
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    raw = torch.cat(flat).cpu().numpy() if len(flat) > 1 else flat[0].cpu().numpy()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(raw[off:off + f.numel()].copy().view(dtype).reshape(t.shape))
        off += f.numel()
    return out
