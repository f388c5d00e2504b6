"""Numerical sanitizers, the counterpart of ``raytracing_tpu.utils.sanitize``.
What can go wrong in this renderer is numerical: a NaN escaping a masked
lane. Out-of-bounds indices in the gather-heavy paths (BVH links, texel
fetches) raise in PyTorch where they happen (an IndexError on the CPU, a
device-side assert on the card), so they need no instrumentation here.

  * :func:`nan_guard`: a context manager under which the first torch call
    whose floating-point output holds a NaN raises ``FloatingPointError``
    naming the call (the counterpart of ``jax_debug_nans``);
  * :func:`checked`: ``checked(fn)`` returns a function computing
    ``(err, out)``; ``err.throw()`` raises if a call inside ``fn`` made a
    NaN (the counterpart of ``checkify``).

Every checked call reads its output's NaN flag on the host: a debugging
tier, a host sync per torch call on the card.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch
from torch.overrides import TorchFunctionMode


def _has_nan(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and bool(torch.isnan(out).any())
    if isinstance(out, (tuple, list)):
        return any(_has_nan(x) for x in out)
    return False


def _name(func) -> str:
    return getattr(func, "__name__", None) or repr(func)


class _NanMode(TorchFunctionMode):
    """Checks the output of every torch call made under it; the first one
    holding a NaN calls ``on_nan(message)``."""

    def __init__(self, on_nan: Callable[[str], None]):
        super().__init__()
        self.on_nan = on_nan

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _has_nan(out):
            self.on_nan(f"nan generated by {_name(func)}")
        return out


def _raise(message: str):
    raise FloatingPointError(message)


@contextlib.contextmanager
def nan_guard(enable: bool = True):
    """Within the scope, any torch call whose floating-point output holds a
    NaN raises ``FloatingPointError`` at that call."""
    if not enable:
        yield
        return
    with _NanMode(_raise):
        yield


class CheckError:
    """The outcome of a :func:`checked` call: ``get()`` is the first error's
    message (None when clean) and ``throw()`` raises it."""

    def __init__(self, message: Optional[str] = None):
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def checked(fn: Callable) -> Callable:
    """Instrument ``fn`` with NaN checks: returns a function computing
    ``(err, out)``; call ``err.throw()`` to raise on failure. ``fn`` runs
    to its end; the first NaN-making call is recorded."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        first = []

        def record(message):
            if not first:
                first.append(message)

        with _NanMode(record):
            out = fn(*args, **kwargs)
        return CheckError(first[0] if first else None), out

    return run
