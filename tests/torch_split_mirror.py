"""Plain-torch mirrors of the split backward pass that the fast_smoother_ll
and laplace_step kernels run (``bssm_tpu_torch/csrc/kalman_common.cuh``):
the forward pass stages v and F with the update mask folded in (F = +inf,
v = 0 where a step updates nothing), c_t and L_t are formed for every t at
once as (w = v / F, g = T K), only the m-vector r chain runs step by step,
and alphahat_t = a_t + P_t r_{t-1} is again a map over t.  Each sum is
accumulated in the kernels' order.  The forward moments come from the
port's plain filter (``ops/kalman.kfilter``).
"""
import torch

from bssm_tpu_torch.core import distributions as tfam
from bssm_tpu_torch.core.spec import SVM, with_batch
from bssm_tpu_torch.ops import kalman as tkalman


def fold(lg):
    """The forward pass of the split smoother: the plain filter, then v
    and F as split_fwd_step stages them, and the update mask."""
    r = tkalman.kfilter(lg)
    ok = tkalman._sys(lg).obs & (r.Ft > tkalman.ZERO_TOL)
    v = torch.where(ok, r.vt, torch.zeros_like(r.vt))
    F = torch.where(ok, r.Ft, torch.full_like(r.Ft, torch.inf))
    return r, ok, v, F


def split_backward(lg):
    """The split backward pass of one time-invariant system per row:
    bwd_terms for every (row, t), bwd_chain last to first, smoothed_mean
    for every (row, t).  Returns a dict of alpha, ll and the per-step
    values."""
    r, ok, v, F = fold(lg)
    B, n = v.shape
    m = r.at.shape[-1]
    Z = with_batch(lg.Z, 2)[:, 0].expand(B, m)            # (B, m)
    T = with_batch(lg.T, 3)[:, 0].expand(B, m, m)         # (B, m, m)
    P = r.Pt[:, :n]                                      # (B, n, m, m)
    # bwd_terms: K = P Z / F, w = v / F, g = T K, every t at once
    K = []
    for i in range(m):
        acc = torch.zeros_like(v)
        for j in range(m):
            acc = acc + P[..., i, j] * Z[:, j, None]
        K.append(acc / F)
    w = v / F
    g = []
    for i in range(m):
        acc = torch.zeros_like(v)
        for l_ in range(m):
            acc = acc + T[:, i, l_, None] * K[l_]
        g.append(acc)
    g = torch.stack(g, dim=-1)                            # (B, n, m)
    # bwd_chain: r_{t-1} = Z w + (T - g Z')' r, one step at a time
    rv = torch.zeros((B, m), dtype=v.dtype)
    rprev = [None] * n
    for t in range(n - 1, -1, -1):
        rn = []
        for j in range(m):
            sl = torch.zeros((B,), dtype=v.dtype)
            for i in range(m):
                sl = sl + (T[:, i, j] - g[:, t, i] * Z[:, j]) * rv[:, i]
            rn.append(Z[:, j] * w[:, t] + sl)
        rv = torch.stack(rn, dim=-1)
        rprev[t] = rv
    rprev = torch.stack(rprev, dim=1)                     # (B, n, m)
    # smoothed_mean: alphahat_t = a_t + P_t r_{t-1}, every t at once
    al = []
    for i in range(m):
        acc = r.at[:, :n, i]
        for j in range(m):
            acc = acc + P[..., i, j] * rprev[..., j]
        al.append(acc)
    alpha = torch.cat([torch.stack(al, dim=-1), r.at[:, n:]], dim=1)
    return {"alpha": alpha, "ll": r.logLik, "v": v, "F": F, "ok": ok,
            "w": w, "g": g, "rprev": rprev, "T": T}


def fixed_order_mean(d: torch.Tensor) -> torch.Tensor:
    """laplace_step's mean of d (B, n) over t: lane l of a warp adds the
    steps t = l (mod 32) from the last, then the warp's butterfly
    (warp_sum), then / n."""
    B, n = d.shape
    lanes = []
    for lane in range(32):
        acc = torch.zeros((B,), dtype=d.dtype)
        for t in range(n - 1, -1, -1):
            if t % 32 == lane:
                acc = acc + d[:, t]
        lanes.append(acc)
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[i] + lanes[i ^ o] for i in range(32)]
    return lanes[0] / n


def split_laplace_step(spec, mode):
    """One pass of laplace_step as the kernel splits it: the
    pseudo-observations of every step at the mode first, the filter, the
    split backward pass, then the new mode and its squared change for
    every step, and their mean in the kernel's order.  Returns (new mode,
    ll, diff)."""
    phi = spec.phi.unsqueeze(-1) if spec.phi.dim() == 1 else spec.phi
    yt, HH = tfam.laplace_match(spec.distribution, spec.y, spec.u, phi,
                                mode)
    yt = torch.where(torch.isfinite(spec.y), yt,
                     torch.full_like(yt, torch.nan))
    HH = torch.where(torch.isfinite(HH) & (HH > 0), HH, torch.ones_like(HH))
    sp = split_backward(spec.approx_gaussian(yt, torch.sqrt(HH)))
    al = sp["alpha"][:, :spec.n]
    if spec.distribution == SVM:
        new = al[..., 0]
    else:
        Z = with_batch(spec.Z, 2)[:, 0]
        new = with_batch(spec.D, 1).expand_as(mode)
        for i in range(al.shape[-1]):
            new = new + Z[:, i, None] * al[..., i]
    return new, sp["ll"], fixed_order_mean(torch.square(new - mode))
