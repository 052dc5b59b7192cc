"""Argument validation with friendly errors.

Own copy of the numpy checks of ``bssm_tpu/core/validate.py`` that the
model constructors of this package call (NaN allowed only in y; positivity
of u/phi; dimension rules for xreg/beta).  The package imports nothing of
the JAX package, so the checks live here too.
"""
from __future__ import annotations

import numpy as np


def check_y(y, distribution=None):
    y = np.asarray(y, dtype=np.float64)
    if y.ndim != 1:
        raise ValueError("Argument 'y' must be a 1d array.")
    if y.shape[0] < 2:
        raise ValueError("Length of argument 'y' must be at least 2.")
    if np.isinf(y).any():
        raise ValueError("Argument 'y' must contain only finite values "
                         "or NA (NaN).")
    if distribution is not None and distribution in (
            "poisson", "binomial", "negative binomial"):
        obs = y[np.isfinite(y)]
        if (obs < 0).any() or (np.abs(obs - np.round(obs)) > 1e-8).any():
            raise ValueError(f"Negative or non-integer values of 'y' not "
                             f"allowed for {distribution} distribution.")
    if distribution == "gamma":
        obs = y[np.isfinite(y)]
        if (obs < 0).any():
            raise ValueError("Negative values of 'y' not allowed for "
                             "gamma distribution.")
    return y


def check_u(u, y):
    u = np.broadcast_to(np.asarray(u, dtype=np.float64),
                        np.asarray(y).shape).copy()
    if (~np.isfinite(u)).any() or (u <= 0).any():
        raise ValueError("Argument 'u' must contain only positive finite "
                         "values.")
    return u




def check_period(period, n):
    if period is None:
        raise ValueError("period required with a seasonal component")
    if int(period) < 3:
        raise ValueError("Argument 'period' must be at least 3.")
    if int(period) >= n:
        raise ValueError("Argument 'period' must be shorter than the "
                         "series.")
    return int(period)


def check_xreg(xreg, n):
    xreg = np.atleast_2d(np.asarray(xreg, dtype=np.float64))
    if xreg.shape[0] == 1 and xreg.size == n:
        xreg = xreg.reshape(n, -1)
    if xreg.shape[0] not in (0, n):
        raise ValueError("Number of rows in xreg is not equal to the "
                         "length of the series y.")
    if not np.isfinite(xreg).all():
        raise ValueError("Argument 'xreg' must contain only finite values.")
    return xreg


def check_beta(beta, k):
    from .priors import Prior
    if isinstance(beta, Prior):
        sz = np.asarray(beta.init).size
    elif isinstance(beta, (list, tuple)) and beta and \
            isinstance(beta[0], Prior):
        sz = len(beta)
    else:
        arr = np.atleast_1d(np.asarray(beta, dtype=np.float64))
        if not np.isfinite(arr).all():
            raise ValueError("Argument 'beta' must contain only finite "
                             "values.")
        sz = arr.size
    if sz != k:
        raise ValueError("Number of coefficients in beta is not equal to "
                         "the number of columns of xreg.")
    return beta
