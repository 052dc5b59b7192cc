"""Posterior diagnostics of an IS-weighted run (numpy).  Counterpart of
``bssm_tpu/diagnostics/summary.py`` for the weighted moments and the
weight-degeneracy effective sample size."""
from __future__ import annotations

import numpy as np


def weighted_mean(x, w):
    return np.sum(w * x) / np.sum(w)


def weighted_var(x, w):
    m = weighted_mean(x, w)
    return np.sum(w * (x - m) ** 2) / np.sum(w)


def ess_is(w) -> float:
    """Weight-degeneracy ESS: (sum w)^2 / sum w^2."""
    w = np.asarray(w, dtype=np.float64)
    return float(np.sum(w) ** 2 / np.sum(w ** 2))
