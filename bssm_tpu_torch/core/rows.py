"""Row windows: the draws of a batch's rows, keyed by their place in the
whole batch.

A run on a mesh (``parallel/``) computes only some rows of a batch on each
rank, yet every row must get the randomness it gets in the unsharded run.
Inside ``window(offset, total)`` the local batch is rows ``offset ..
offset + B - 1`` of a batch of ``total`` rows: every draw site of the
package makes its draw with the whole batch's shape from its generator,
as the unsharded run does, and keeps this window's rows (``draw``,
``randn``, ``rand``), and the kernels that make their own randomness from
a Philox key count their rows from ``offset()``.  Outside a window the
local batch is the whole batch and every function here is the plain
draw.  The window is process-wide state, set by the caller around a block
of calls (``run_mcmc`` around a chain, a chunk of the correction or of
the state draws).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch

_window: Optional[tuple] = None


@contextlib.contextmanager
def window(offset: int, total: int):
    """Local batches are rows ``offset ..`` of ``total`` rows inside the
    block (an empty one may start at ``total``); the old window is restored
    after it, also when it raises."""
    global _window
    if not 0 <= int(offset) <= int(total):
        raise ValueError(f"row window at {offset} of {total} rows")
    old = _window
    _window = (int(offset), int(total))
    try:
        yield
    finally:
        _window = old


def offset() -> int:
    """The global index of the local batch's first row (0 outside a
    window)."""
    return 0 if _window is None else _window[0]


def draw(fn: Callable, shape: Sequence[int], axis: int = 0) -> torch.Tensor:
    """``fn(shape)`` for the local rows: ``shape[axis]`` is the local batch
    size; inside a window ``fn`` draws the whole batch and the window's rows
    are kept (contiguous)."""
    shape = tuple(int(s) for s in shape)
    if _window is None:
        return fn(shape)
    off, total = _window
    if off + shape[axis] > total:
        raise ValueError(f"{shape[axis]} rows at {off} overrun a window of "
                         f"{total} rows")
    full = shape[:axis] + (total,) + shape[axis + 1:]
    return fn(full).narrow(axis, off, shape[axis]).contiguous()


def randn(shape: Sequence[int], axis: int = 0, **kw) -> torch.Tensor:
    """``torch.randn(shape, **kw)`` of the local rows."""
    return draw(lambda s: torch.randn(s, **kw), shape, axis)


def rand(shape: Sequence[int], axis: int = 0, **kw) -> torch.Tensor:
    """``torch.rand(shape, **kw)`` of the local rows."""
    return draw(lambda s: torch.rand(s, **kw), shape, axis)
