"""Posterior diagnostics (numpy): IACT, IS asymptotic variance, ESS,
summaries.

Own copy of ``bssm_tpu/diagnostics/summary.py``, the package imports
nothing of the JAX package.  These run on the host over the stored draws
of an ``McmcOutput``; ``iact`` over more than 2000 draws calls the native
library (``bssm_tpu_torch/native``) when it builds.

Key quantities for an IS-weighted run (Vihola, Helske & Franks 2020, Cor. 1):
  asymptotic var  = Var(z) IACT(z) / cbar^2 / n,   z = w (x - xbar_w)
  ESS             = Var_w(x) / asymptotic_var
  ESS_IS          = (sum w)^2 / sum(w^2) ... weight-degeneracy ESS
"""
from __future__ import annotations

import numpy as np


def iact(x: np.ndarray) -> float:
    """Sokal's adaptive-window integrated autocorrelation time."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    sd = x.std(ddof=1)
    if sd == 0 or n < 2:
        return 0.0
    xs = (x - x.mean()) / sd
    if n > 2000:
        from ..native import get_lib
        lib = get_lib()
        if lib is not None:
            return float(lib.bssm_iact(np.ascontiguousarray(xs), n))
    C = max(5.0, np.log10(n))
    tau = 1.0
    # vectorised: all lag covariances at once, then the adaptive stop
    for k in range(1, n):
        tau += 2.0 * np.dot(xs[:n - k], xs[k:]) / (n - k)
        if k > C * tau:
            break
    return max(0.0, tau)


def weighted_mean(x, w):
    return np.sum(w * x) / np.sum(w)


def weighted_var(x, w):
    m = weighted_mean(x, w)
    return np.sum(w * (x - m) ** 2) / np.sum(w)


def asymptotic_var(x, w=None) -> float:
    """IS-MCMC asymptotic variance of the weighted mean estimate."""
    x = np.asarray(x, dtype=np.float64)
    w = np.ones_like(x) if w is None else np.asarray(w, dtype=np.float64)
    cbar = w.mean()
    z = w * (x - weighted_mean(x, w))
    return z.var(ddof=1) * iact(z) / cbar ** 2 / len(z)


def estimate_ess(x, w=None) -> float:
    """Effective sample size accounting for autocorrelation and
    weights."""
    x = np.asarray(x, dtype=np.float64)
    w = np.ones_like(x) if w is None else np.asarray(w, dtype=np.float64)
    av = asymptotic_var(x, w)
    if av <= 0:
        return float(len(x))
    return float(weighted_var(x, w) / av)


def ess_is(w) -> float:
    """Weight-degeneracy ESS: (sum w)^2 / sum w^2."""
    w = np.asarray(w, dtype=np.float64)
    return float(np.sum(w) ** 2 / np.sum(w ** 2))


def rhat(chains: np.ndarray) -> float:
    """Split-chain potential scale reduction factor; chains (C, S)."""
    c = np.asarray(chains, dtype=np.float64)
    if c.ndim == 1:
        c = c[None]
    C, S = c.shape
    half = S // 2
    c = np.concatenate([c[:, :half], c[:, half:2 * half]], axis=0)
    W = c.var(axis=1, ddof=1).mean()
    B = half * c.mean(axis=1).var(ddof=1)
    if W == 0:
        return 1.0
    return float(np.sqrt((half - 1) / half + B / (W * half)))


# --------------------------------------------------------------------------
# rank-normalised diagnostics (Vehtari, Gelman, Simpson, Carpenter & Burkner
# 2021), what the R package prints through the `posterior` package
# --------------------------------------------------------------------------

def _split_chains(c: np.ndarray) -> np.ndarray:
    """(C, S) -> (2C, S//2): first/second halves as separate chains."""
    half = c.shape[1] // 2
    return np.concatenate([c[:, :half], c[:, half:2 * half]], axis=0)


def _rank_normalize(c: np.ndarray) -> np.ndarray:
    """Pooled average ranks -> normal scores z = ndtri((r - 3/8)/(n + 1/4));
    ties get the average rank (matters for indicator draws)."""
    from scipy.special import ndtri
    shape = c.shape
    x = c.reshape(-1)
    n = x.size
    _, inv, cnt = np.unique(x, return_inverse=True, return_counts=True)
    csum = np.cumsum(cnt)
    avg_rank = (csum - cnt + 1 + csum) / 2.0
    r = avg_rank[inv]
    return ndtri((r - 0.375) / (n + 0.25)).reshape(shape)


def _ess_mean(c: np.ndarray) -> float:
    """Multi-chain ESS of the mean: combined autocorrelations with Geyer's
    initial monotone positive-pair truncation (the posterior/Stan estimator;
    formulas from Vehtari et al. 2021 eq. 10-13)."""
    c = np.asarray(c, dtype=np.float64)
    if c.ndim == 1:
        c = c[None]
    C, S = c.shape
    if S < 4 or not np.all(np.isfinite(c)):
        return float("nan")
    if np.allclose(c, c.flat[0]):
        return float("nan")
    means = c.mean(axis=1, keepdims=True)
    W = c.var(axis=1, ddof=1).mean()
    var_plus = W * (S - 1) / S
    if C > 1:
        var_plus += means.var(ddof=1)
    if var_plus == 0:
        return float("nan")
    # per-chain autocovariances via FFT (biased, /S)
    xc = c - means
    nfft = 1 << int(np.ceil(np.log2(2 * S)))
    f = np.fft.rfft(xc, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :S].real / S
    rho = 1.0 - (W - acov.mean(axis=0)) / var_plus       # rho[0] == 1
    # Geyer pairs: P_k = rho_{2k} + rho_{2k+1}; stop at first negative pair,
    # then enforce monotone non-increasing
    kmax = (S - 1) // 2
    tau = -rho[0]                                        # = -1
    prev = np.inf
    for k in range(kmax + 1):
        if 2 * k + 1 >= S:
            break
        P = rho[2 * k] + rho[2 * k + 1]
        if P < 0:
            break
        P = min(P, prev)
        prev = P
        tau += 2.0 * P
    tau = max(tau, 1.0 / np.log10(C * S + 10.0))
    ess = C * S / tau
    return float(min(ess, C * S * np.log10(C * S)))


def ess_bulk(chains: np.ndarray) -> float:
    """Bulk-ESS: ESS of the rank-normalised split chains."""
    c = np.asarray(chains, dtype=np.float64)
    if c.ndim == 1:
        c = c[None]
    return _ess_mean(_rank_normalize(_split_chains(c)))


def ess_tail(chains: np.ndarray) -> float:
    """Tail-ESS: min ESS of the 5% / 95% quantile-indicator draws."""
    c = np.asarray(chains, dtype=np.float64)
    if c.ndim == 1:
        c = c[None]
    sp = _split_chains(c)
    out = []
    for p in (0.05, 0.95):
        ind = (sp <= np.quantile(sp, p)).astype(np.float64)
        out.append(_ess_mean(_rank_normalize(ind)))
    return float(np.nanmin(out))


def rhat_rank(chains: np.ndarray) -> float:
    """Rank-normalised split-Rhat folded with the |x - median| version:
    max of the two (the `posterior` package's default rhat)."""
    c = np.asarray(chains, dtype=np.float64)
    if c.ndim == 1:
        c = c[None]
    sp = _split_chains(c)

    def _rhat_basic(x):
        W = x.var(axis=1, ddof=1).mean()
        if W == 0:
            return 1.0
        S = x.shape[1]
        B = S * x.mean(axis=1).var(ddof=1)
        var_plus = W * (S - 1) / S + B / S
        return float(np.sqrt(var_plus / W))

    bulk = _rhat_basic(_rank_normalize(sp))
    folded = _rhat_basic(_rank_normalize(np.abs(sp - np.median(sp))))
    return max(bulk, folded)


def summary(output, variable: str = "theta", return_se: bool = False,
            probs=(0.025, 0.5, 0.975)):
    """Weighted posterior summaries as the R package's
    ``summary.mcmc_output``: Mean, SE (= sqrt asymptotic var), SD,
    quantiles, ESS, ESS_IS; one dict a parameter ("theta") or a (time,
    state) pair ("states", which needs full output)."""
    w = output.flat_weights()
    rows = []
    if variable == "theta":
        th = output.flat_theta()
        names = output.theta_names
        for j, name in enumerate(names):
            x = th[:, j]
            row = {"variable": name, "Mean": weighted_mean(x, w),
                   "SD": np.sqrt(weighted_var(x, w))}
            for p in probs:
                row[f"{100 * p:g}%"] = _weighted_quantile(x, w, p)
            if return_se:
                row["SE"] = np.sqrt(max(asymptotic_var(x, w), 0.0))
                row["ESS"] = estimate_ess(x, w)
                row["ESS_IS"] = ess_is(w)
            rows.append(row)
    elif variable == "states":
        if output.alpha is None:
            raise ValueError("state summaries need output_type='full'")
        a = output.alpha.reshape((-1,) + output.alpha.shape[2:])
        n1, m = a.shape[1], a.shape[2]
        for t in range(n1):
            for j in range(m):
                x = a[:, t, j]
                row = {"variable": f"state_{j + 1}", "time": t,
                       "Mean": weighted_mean(x, w),
                       "SD": np.sqrt(weighted_var(x, w))}
                if return_se:
                    row["SE"] = np.sqrt(max(asymptotic_var(x, w), 0.0))
                    row["ESS"] = estimate_ess(x, w)
                rows.append(row)
    else:
        raise ValueError(variable)
    return rows


def _weighted_quantile(x, w, p):
    order = np.argsort(x)
    cw = np.cumsum(w[order])
    cw /= cw[-1]
    return float(np.interp(p, cw, x[order]))


def check_diagnostics(output) -> str:
    """Quick-check printout: run time, acceptance rate, ESS, bulk/tail ESS
    and rank-normalised Rhat of each parameter, and the IS weights' ESS."""
    lines = []
    if output.time:
        t = sum(v for v in output.time.values())
        lines.append(f"Run time: {t:.2f} s")
    lines.append(f"Acceptance rate after burn-in: "
                 f"{output.acceptance_rate:.3f}")
    th = output.theta
    w = output.flat_weights()
    for j, name in enumerate(output.theta_names):
        x = th[..., j].reshape(-1)
        e = estimate_ess(x, w)
        eb = ess_bulk(th[..., j])
        et = ess_tail(th[..., j])
        r = rhat_rank(th[..., j])
        lines.append(f"  {name}: ESS {e:.0f}, bulk-ESS {eb:.0f}, "
                     f"tail-ESS {et:.0f}, Rhat {r:.3f}")
    if output.weights is not None:
        lines.append(f"IS weight ESS: {ess_is(w):.0f} / {len(w)}")
    return "\n".join(lines)
