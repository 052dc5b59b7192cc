"""One CUDA graph for a block of tensor code that a chain repeats at every
iteration with the same shapes.

The filters with trajectories, SPDK's simulation smoother and the
multivariate models' Kalman passes are batched tensor code in a Python
loop over time: some thousands of small device operations a call, each
issued by the host.  Pseudo-marginal and delayed-acceptance chains with
state output (or SPDK), and the multivariate chains (a Laplace pass, a
filter's estimate, the linear-Gaussian log-likelihood), call them once or
a few times an iteration on tensors of the same shapes, so ``Replay``
captures one call as a CUDA graph and replays it after, with the new
inputs copied into the captured ones.  Randomness is drawn outside, from
the caller's generator, so a replayed call computes what the eager call
computes.

The kernels inside (``rts_factors``, ``fast_smoother_ll``) run on every
replay.  Their wrappers count in ``cuda_kalman.LAUNCHES`` only where they
launch: in the eager warm-up before a capture.  The capture records their
launches without running them and counts nothing; each replay adds what
the graph holds to ``cuda_kalman.REPLAYED``, apart from the wrappers'
counts.  On the CPU the function runs as it is.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..ops import cuda_kalman


def _flatten(spec, args):
    """Leaves and structure of ``(spec's fields, args)``; a spec is a
    dataclass or a NamedTuple."""
    fields = spec._asdict() if isinstance(spec, tuple) else {
        f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    return tree_flatten((fields, args))


class Replay:
    """``replay(fn, spec, *args)`` returns ``fn(spec, *args)``, a tuple of
    tensors: eagerly on the CPU, through one CUDA graph per distinct
    (function, structure, shapes) on the card."""

    def __init__(self):
        self._graphs = {}

    def __call__(self, fn, spec, *args):
        if not spec.y.is_cuda:
            return fn(spec, *args)
        leaves, tree = _flatten(spec, args)
        is_t = [torch.is_tensor(x) for x in leaves]
        key = (fn, tree, tuple((x.shape, x.dtype, x.stride()) if t else x
                               for x, t in zip(leaves, is_t)))
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(fn, type(spec), leaves, is_t, tree)
            self._graphs[key] = entry
        graph, static, out, delta = entry
        for s, x, t in zip(static, leaves, is_t):
            if t:
                s.copy_(x)
        graph.replay()
        for k, v in delta.items():
            cuda_kalman.REPLAYED[k] += v
        return tuple(o.clone() for o in out)

    @staticmethod
    def _capture(fn, spec_type, leaves, is_t, tree):
        static = [x.clone() if t else x for x, t in zip(leaves, is_t)]

        def run():
            fields, args = tree_unflatten(static, tree)
            return fn(spec_type(**fields), *args)

        dev = next(x for x, t in zip(leaves, is_t) if t).device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):         # warm-up: real launches
            run()
        torch.cuda.current_stream(dev).wait_stream(side)
        counts = cuda_kalman.LAUNCHES
        before = dict(counts)
        graph = torch.cuda.CUDAGraph()
        # relaxed: the kernels' launches set function attributes, which
        # the global mode refuses while a stream captures
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            out = run()
        # what the graph holds; the capture itself ran nothing
        delta = {k: counts[k] - before[k] for k in counts
                 if counts[k] != before[k]}
        counts.update(before)
        return graph, static, tuple(out), delta
