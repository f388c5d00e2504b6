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

A :class:`WhileProgram` does the same for a loop whose trip count only
the device knows, as the JAX package's pool runs each sample window as
one compiled ``lax.while_loop``: its ``step()`` sets a device flag, and
on a card one captured step sits inside a CUDA graph WHILE node
(``csrc/graph_while.cu``), so a whole loop is one graph launch.

The kernels' launch counts (``_kernels.LaunchCount``) are device counters
that each wrapper adds to on its launch stream, so a replay adds the
launches it runs, as an eager launch does; the stage clock's marks
(``utils/profiling.py``) are captured and add up the same way.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import time
from typing import Callable, Optional

import torch

from .. import _kernels
from ..utils.profiling import annotate, enabled


def _capture(warm_up: Callable[[], None], body: Callable[[], None], device,
             keep_graph: bool = False) -> torch.cuda.CUDAGraph:
    """A CUDA graph of one ``body()``, captured after ``warm_up()`` has
    run on a side stream (as ``torch.cuda.graph`` requires). Capture
    errors propagate."""
    with annotate("rt.program.capture"):
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm_up()
        current.wait_stream(side)
        # A dead program in a reference cycle (its step holds its owner)
        # that Python's cycle collector frees mid-capture destroys its
        # graph then, and that invalidates this capture: collect now, and
        # keep the collector off until the capture has ended.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            graph = (torch.cuda.CUDAGraph(keep_graph=True) if keep_graph
                     else torch.cuda.CUDAGraph())
            with torch.cuda.graph(graph):
                body()
        finally:
            if collecting:
                gc.enable()
        return graph


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
        with annotate("rt.program.init"):
            start()
        self.replay(n)
        return spent

    def _capture(self, start: Callable[[], None]) -> float:
        t0 = time.perf_counter()

        def warm_up():
            start()
            self._step()

        self.graph = _capture(warm_up, self._step, self.device)
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


class WhileProgram:
    """``step()`` on static buffers ``state`` while the 0-d bool device
    tensor ``flag`` is true, the flag tested before every step (the first
    included), as ``lax.while_loop`` tests its condition; the step writes
    the flag. :meth:`run` runs the loop to its end once.

    ``fused`` on a card: one step is captured as a CUDA graph and wrapped
    in a graph with a device-side WHILE node on the flag
    (``csrc/graph_while.cu``), launched once a run, so the host reads
    nothing. Otherwise (the CPU, or ``fused=False``) the loop runs eagerly
    and reads the flag once an iteration. The program keeps the captured
    graph, and with it its memory pool, as long as the WHILE graph."""

    def __init__(self, step: Callable[[], None], flag: torch.Tensor, device, state,
                 fused: bool = True):
        if flag.shape != () or flag.dtype != torch.bool:
            raise ValueError(f"flag must be a 0-d bool tensor, got {tuple(flag.shape)} "
                             f"{flag.dtype}")
        self.step = step
        self.flag = flag
        self.device = torch.device(device)
        if flag.device != self.device:
            raise ValueError(f"flag lies on {flag.device}, the program on {self.device}")
        self.state = state
        self.fused = fused
        self.prepared = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None  # the captured step
        self._exec = None  # the WHILE graph (cudaGraphExec_t)
        self.capture_seconds = 0.0  # warm-up, capture and build, once

    def run(self, init: Callable[[], None]) -> float:
        """The loop to its end after ``init()`` sets the state and the
        flag. With ``fused`` the first run prepares: ``init()`` and one
        warm-up step (on a side stream on a card), then, on a card, the
        capture of one step and the WHILE graph's build; it returns the
        seconds that took, which a caller's timing leaves out (0.0
        otherwise). A graph that cannot be captured, built or launched
        raises: there is no eager fallback."""
        spent = self._prepare(init) if self.fused and not self.prepared else 0.0
        with annotate("rt.program.init"):
            init()
        self.replay(1)
        return spent

    def _prepare(self, init: Callable[[], None]) -> float:
        t0 = time.perf_counter()

        def warm_up():
            init()
            self.step()

        if self.device.type == "cuda":
            graph = _capture(warm_up, self.step, self.device, keep_graph=True)
            lib = _kernels.library().lib
            exe = ctypes.c_void_p()
            err = lib.rt_while_build(graph.raw_cuda_graph(), self.flag.data_ptr(),
                                     ctypes.byref(exe))
            if err != 0:
                raise RuntimeError("building the WHILE graph around the captured step failed: "
                                   f"{lib.rt_error_string(err).decode()}")
            self.graph, self._exec = graph, exe
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()  # as ChunkProgram._capture
        else:
            warm_up()
        self.prepared = True
        self.capture_seconds = time.perf_counter() - t0
        return self.capture_seconds

    def replay(self, n: int = 1) -> None:
        """``n`` runs of the loop on the state as it stands (a loop whose
        flag is false runs no step), with no host synchronization on a
        card's fused program."""
        if self._exec is None:
            if self.fused and self.device.type == "cuda":
                raise RuntimeError("WhileProgram.replay before its capture on a CUDA device")
            for _ in range(n):
                while bool(self.flag):
                    self.step()
            return
        lib = _kernels.library().lib
        stream = torch.cuda.current_stream(self.device).cuda_stream
        for _ in range(n):
            err = lib.rt_while_launch(self._exec, stream)
            if err != 0:
                raise RuntimeError("WHILE graph launch failed: "
                                   f"{lib.rt_error_string(err).decode()}")

    def __del__(self):
        if getattr(self, "_exec", None) is not None and _kernels._loaded is not None:
            _kernels._loaded.lib.rt_while_destroy(self._exec)
            self._exec = None


class ProgramSlot:
    """One program (a :class:`ChunkProgram` or a :class:`WhileProgram`) at
    a time: a new key drops the old program (and its graph's memory pool)
    before the new one is built. The key holds whether the port's tracing
    switch is on (``utils.profiling.enabled``): a program captured with
    the stage clock's marks is never replayed with the switch off, nor the
    reverse."""

    def __init__(self):
        self.key = None
        self.program = None

    def get(self, key, make: Callable[[], object]):
        key = (key, enabled())
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
    with annotate("rt.to_host"):
        flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
        raw = torch.cat(flat).cpu().numpy() if len(flat) > 1 else flat[0].cpu().numpy()
        out, off = [], 0
        for t, f in zip(tensors, flat):
            dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            out.append(raw[off:off + f.numel()].copy().view(dtype).reshape(t.shape))
            off += f.numel()
        return out
