"""Bootstrap particle filtering for SDE models, batched over rows of theta.

Counterpart of ``bssm_tpu/inference/sde.py``.  Each of B rows runs N
particles; each particle's 2^L-step Milstein path over a unit interval is
tensor code over all (row, particle) pairs at once, the model's functions
called once a Milstein step (``models/sde.py``).  Resampling is stratified
at every step; the last propagation (to n + 1) is not weighted.

The randomness comes in one of two modes:

- **stream**: the caller injects the Brownian increments at the generating
  level, ``dBf (B, n+1, N, 2^gen_L)`` (interval 0 carries x0 to alpha_1),
  and the resampling uniforms ``us (B, n, N)`` (``us[:, t]`` before the
  propagation to interval t + 1);
- **seeded**: the same tensors are drawn from a counter-based generator,
  Philox-4x32-10 (``ops/cuda_kalman.philox4x32_10``) keyed by a per-row
  seed ``seeds (B,)`` (int64, two 32-bit key words), the counter indexed by
  (particle slot, group of four fine steps, interval, which): which 0
  gives the increments, four standard normals a call by Box-Muller, which
  1 the resampling uniform of the step that propagates into that interval.
  Every draw is a function of (seed, slot, interval, fine step) alone, so
  a coarse run (L_c, ``couple=True``) and a fine run (L_f) from one seed
  share the Brownian path, the coarse increments being the sums of the
  fine ones, and the resampling uniforms, on every slot they share.  This
  replaces the JAX package's shared threefry key (and the reference's
  ``coarse_engine``); it is plain tensor code, on the card as on the CPU.

The multilevel IS weight and delayed-acceptance ratio exp(ll_f - ll_c) of
``run_mcmc`` rest on that coupling.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..core import rows
from ..models.sde import SDESpec, milstein
from ..ops.cuda_kalman import _u01, philox4x32_10
from ..ops.resample import stratified_indices_from_uniforms

# int64 counters a seeded filter materialises at once (a block of intervals)
BLOCK_COUNTERS = 1 << 22


class SDEPFResult(NamedTuple):
    loglik: torch.Tensor     # (B,)
    alpha: torch.Tensor      # (B, N, n+1, 1)
    weights: torch.Tensor    # (B, N, n+1)
    indices: torch.Tensor    # (B, N, n)


def new_seeds(B: int, device, generator: Optional[torch.Generator] = None
              ) -> torch.Tensor:
    """``(B,)`` int64 seeds of the seeded mode, drawn from ``generator``
    without a host synchronisation."""
    return rows.draw(lambda s: torch.randint(
        0, 2 ** 62, s, dtype=torch.int64, device=device,
        generator=generator), (B,))


def philox_draws(seeds: torch.Tensor, N: int, gen_L: int, s0: int, s1: int,
                 dtype):
    """The seeded mode's draws of intervals ``s0 .. s1 - 1``: increments
    ``(B, S, N, 2^gen_L)`` of a unit interval and uniforms ``(B, S, N)``
    (those of interval 0 are drawn but never used)."""
    dev = seeds.device
    nf = 1 << gen_L
    G = (nf + 3) // 4
    ar = lambda k: torch.arange(k, dtype=torch.int64, device=dev)  # noqa
    B, S = seeds.shape[0], s1 - s0
    s = (ar(S) + s0)[None, :, None, None]
    p = ar(N)[None, None, :, None]
    g = ar(G + 1)[None, None, None, :]
    zero = torch.zeros((B, S, N, G + 1), dtype=torch.int64, device=dev)
    ctr = [p + zero, torch.where(g < G, g, 0) + zero, s + zero,
           (g == G).to(torch.int64) + zero]
    key = ((seeds & 0xFFFFFFFF)[:, None, None, None],
           ((seeds >> 32) & 0xFFFFFFFF)[:, None, None, None])
    w = philox4x32_10(ctr, key)
    us = _u01(w[0][..., G], dtype)
    zs = []
    for a, b in ((0, 1), (2, 3)):
        rad = torch.sqrt(-2.0 * torch.log(_u01(w[a][..., :G], dtype)))
        ang = (2.0 * math.pi) * _u01(w[b][..., :G], dtype)
        zs += [rad * torch.cos(ang), rad * torch.sin(ang)]
    z = torch.stack(zs, dim=-1).reshape(B, S, N, 4 * G)[..., :nf]
    return math.sqrt(1.0 / nf) * z, us


def _lse(logw: torch.Tensor, N: int):
    """Log of the mean weight and the normalised weights of every row
    ``(B, N)``; non-finite log-weights count as zero weight, and a row with
    no positive weight gets -inf and uniform weights."""
    logw = torch.where(torch.isfinite(logw), logw,
                       torch.full_like(logw, -torch.inf))
    mx = logw.max(-1, keepdim=True).values
    w = torch.exp(logw - mx)
    sw = w.sum(-1, keepdim=True)
    ok = (sw > 0) & torch.isfinite(mx)
    inc = torch.where(ok, mx + torch.log(sw / N),
                      torch.full_like(mx, -torch.inf))
    nw = torch.where(ok, w / torch.where(sw > 0, sw, torch.ones_like(sw)),
                     torch.full_like(w, 1.0 / N))
    return inc[..., 0], nw


def _check_stream(spec, N, gen_L, dBf, us):
    B, n = spec.batch, spec.n
    want = ((B, n + 1, N, 1 << gen_L), (B, n, N))
    for name, x, shape in (("dBf", dBf, want[0]), ("us", us, want[1])):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{shape}")


def bsf_filter_sde(spec: SDESpec, nsim: int, L: int, couple: bool = False,
                   *, seeds: Optional[torch.Tensor] = None, dBf=None,
                   us=None, generator: Optional[torch.Generator] = None,
                   keep_paths: bool = True):
    """Bootstrap filter of every row at discretisation level 2^L with
    ``nsim`` particles.  With ``couple=True`` the increments are drawn at
    the fine level ``spec.L_f`` and summed onto the 2^L grid (the coarse
    filter of a coupled pair).  Randomness: ``dBf`` and ``us`` (stream
    mode), or ``seeds (B,)`` (seeded mode), drawn from ``generator`` when
    neither is given.  Returns an ``SDEPFResult`` (``alpha`` untraced, as
    ``ancestor_trace`` takes it), or without ``keep_paths`` the
    log-likelihood ``(B,)`` alone."""
    N, L = int(nsim), int(L)
    gen_L = spec.L_f if couple else L
    if L > gen_L:
        raise ValueError(f"level {L} is finer than the generating level "
                         f"{gen_L}")
    if dBf is not None or us is not None:
        _check_stream(spec, N, gen_L, dBf, us)
        seeds = None
    elif seeds is None:
        seeds = new_seeds(spec.batch, spec.y.device, generator)
    return _filter(spec, N, L, gen_L, seeds, dBf, us, keep_paths)


def _filter(spec: SDESpec, N: int, L: int, gen_L: int, seeds, dBf, us,
            keep_paths: bool):
    B, n = spec.batch, spec.n
    dt, dev = spec.y.dtype, spec.y.device
    nf = 1 << gen_L
    th = spec.theta.repeat_interleave(N, dim=0)            # (B N, d)
    if seeds is not None:
        G = (nf + 3) // 4
        blk = max(1, min(n + 1, BLOCK_COUNTERS // (B * N * (G + 1))))
    cache = {}

    def draws(s):
        """(increments (B N, nf), uniforms (B, N)) of interval ``s``."""
        if seeds is None:
            u = us[:, s - 1] if s > 0 else None
            return dBf[:, s].reshape(B * N, nf), u
        b0 = s - s % blk
        if cache.get("b0") != b0:
            cache["b0"] = b0
            cache["d"] = philox_draws(seeds, N, gen_L, b0,
                                      min(b0 + blk, n + 1), dt)
        inc, uni = cache["d"]
        return inc[:, s - b0].reshape(B * N, nf), uni[:, s - b0]

    def weigh(t, x):
        """(increment (B,), normalised weights (B, N)) of observation t."""
        ok = torch.isfinite(spec.y[t])
        lw = spec.log_obs_density(spec.y[t].expand(B * N), x, th)
        inc, nw = _lse(torch.where(ok, lw, torch.zeros_like(lw)).reshape(
            B, N), N)
        return (torch.where(ok, inc, torch.zeros_like(inc)),
                torch.where(ok, nw, torch.full_like(nw, 1.0 / N)))

    x0 = torch.full((B * N,), spec.x0, dtype=dt, device=dev)
    x = milstein(spec, x0, L, dBf=draws(0)[0], theta=th)
    ll, nw = weigh(0, x)
    xs, ws, idxs = [x], [nw], []
    for t in range(n):
        inc_t, u = draws(t + 1)
        idx = stratified_indices_from_uniforms(nw, u)
        anc = torch.gather(x.reshape(B, N), 1, idx).reshape(B * N)
        x = milstein(spec, anc, L, dBf=inc_t, theta=th)
        if t + 1 < n:
            inc, nw = weigh(t + 1, x)
            ll = ll + inc
        else:                            # the prediction beyond the data
            nw = torch.full_like(nw, 1.0 / N)
        if keep_paths:
            xs.append(x)
            ws.append(nw)
            idxs.append(idx)
    if not keep_paths:
        return ll
    alpha = torch.stack(xs, dim=-1).reshape(B, N, n + 1, 1)
    return SDEPFResult(ll, alpha, torch.stack(ws, dim=-1),
                       torch.stack(idxs, dim=-1))
