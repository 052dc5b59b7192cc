"""Argument validation with friendly errors.

Own copy of the numpy checks of ``bssm_tpu/core/validate.py``, all 26 of
them, with the JAX package's signatures: NaN allowed only in y; positivity
of u; the families' supports; dimension rules for Z/H/T/R/a1/P1/D/C and
xreg/beta, the multivariate branches included; the scalar checks of sds,
phi, rho, proportions, counts and theta.  The same input gives the same
result, and the same bad input the same exception and message, as in the
JAX package.  The package imports nothing of the JAX package, so the
checks live here too; ``check_beta``, ``check_mu`` and ``check_prior``
recognise this package's priors (``core/priors.py``).
"""
from __future__ import annotations

import numpy as np


def check_y(y, multivariate=False, distribution=None):
    y = np.asarray(y, dtype=np.float64)
    if multivariate:
        if y.ndim != 2:
            raise ValueError("Argument 'y' must be a 2d array (n, p) for "
                             "multivariate models.")
    elif y.ndim != 1:
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


def check_sd(x, name):
    if not np.isscalar(x) and np.asarray(x).size != 1:
        raise ValueError(f"Argument 'sd_{name}' must be a scalar or prior.")
    if float(np.asarray(x).reshape(())) < 0:
        raise ValueError(f"Standard deviation parameter 'sd_{name}' must "
                         "be non-negative.")


def check_phi(x):
    if float(x) <= 0:
        raise ValueError("Parameter 'phi' must be positive.")


def check_rho(x):
    if not (-1.0 < float(x) < 1.0):
        raise ValueError("Parameter 'rho' must be strictly between -1 "
                         "and 1.")


def check_prop(x, name="target_acceptance"):
    if not (0.0 < float(x) < 1.0):
        raise ValueError(f"Argument '{name}' must be on the open interval "
                         "(0, 1).")


def check_positive_int(x, name):
    if int(x) != x or x <= 0:
        raise ValueError(f"Argument '{name}' must be a positive integer.")


def check_matrix(x, name, shape):
    x = np.asarray(x, dtype=np.float64)
    if x.shape != tuple(shape):
        raise ValueError(f"Argument '{name}' must have shape {shape}, "
                         f"got {x.shape}.")
    if not np.isfinite(x).all():
        raise ValueError(f"Argument '{name}' must contain only finite "
                         "values.")
    return x


def check_period(period, n):
    if period is None:
        raise ValueError("period required with a seasonal component")
    if int(period) < 3:
        raise ValueError("Argument 'period' must be at least 3.")
    if int(period) >= n:
        raise ValueError("Argument 'period' must be shorter than the "
                         "series.")
    return int(period)


def check_distribution(y, distributions):
    """Per-series support checks of a multivariate non-Gaussian y ``(n, p)``
    against the family names ``distributions``."""
    y = np.asarray(y, dtype=np.float64)
    for j, dist in enumerate(distributions):
        col = y[:, j]
        obs = col[np.isfinite(col)]
        if dist != "gaussian" and (obs < 0).any():
            raise ValueError(f"Negative values not allowed for {dist} "
                             "distribution.")
        if dist in ("negative binomial", "binomial", "poisson") and \
                (np.abs(obs - np.round(obs)) > 1e-8).any():
            raise ValueError(f"Non-integer values not allowed for {dist} "
                             "distribution.")


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


def check_mu(mu):
    from .priors import Prior
    if isinstance(mu, Prior):
        return mu
    arr = np.asarray(mu, dtype=np.float64)
    if arr.size != 1:
        raise ValueError("Argument 'mu' must be of length one.")
    if not np.isfinite(arr).all():
        raise ValueError("Argument 'mu' must contain only finite values.")
    return mu


def check_prior(x, name):
    from .priors import Prior
    if isinstance(x, Prior):
        return x
    if isinstance(x, (list, tuple)) and x and \
            all(isinstance(p, Prior) for p in x):
        return x
    raise TypeError(f"{name} must be a Prior or a list of Priors.")


def check_D(D, p, n):
    """Observation intercept: scalar or (n,) for one series, returned 1-D;
    (p,), (p, 1) or (p, n) for p > 1 series, returned (p, 1|n)."""
    if D is None:
        return np.zeros(1) if p == 1 else np.zeros((p, 1))
    D = np.asarray(D, dtype=np.float64)
    if p == 1:
        if D.size not in (1, n):
            raise ValueError("'D' must be a scalar or length n, where n is "
                             "the number of observations.")
        return D.reshape(-1)
    if D.ndim == 1 and D.size == p:
        D = D.reshape(p, 1)
    if D.ndim != 2 or D.shape[0] != p or D.shape[1] not in (1, n):
        raise ValueError("'D' must be p x 1 or p x n matrix, where p is "
                         "the number of series.")
    return D


def check_C(C, m, n):
    """State intercept: (m,), (m, 1) or (m, n), returned (m, 1|n)."""
    if C is None:
        return np.zeros((m, 1))
    C = np.asarray(C, dtype=np.float64)
    if C.ndim == 1 and C.size == m:
        C = C.reshape(m, 1)
    if C.ndim != 2 or C.shape[0] != m or C.shape[1] not in (1, n):
        raise ValueError("'C' must be m x 1 or m x n matrix, where m is "
                         "the number of states.")
    return C


def check_Z(Z, p, n, multivariate=False):
    """Observation vector: scalar, (m,) or (m, n), returned (m, 1|n); with
    ``multivariate`` a (p, m) matrix or (p, m, n) array, returned
    (p, m, 1|n)."""
    Z = np.asarray(Z, dtype=np.float64)
    if multivariate:
        if Z.ndim == 2:
            Z = Z[..., None]
        if Z.ndim != 3 or Z.shape[0] != p or Z.shape[2] not in (1, n):
            raise ValueError(
                "'Z' must be a (p x m) matrix or (p x m x n) array where p "
                "is the number of series, m is the number of states, and n "
                "is the length of the series.")
        return Z
    if Z.ndim == 0:
        return Z.reshape(1, 1)
    if Z.ndim == 1:
        return Z.reshape(-1, 1)
    if Z.ndim != 2 or Z.shape[1] not in (1, n):
        raise ValueError(
            "'Z' must be a (m x 1) or (m x n) matrix, where m is the "
            "number of states and n is the length of the series.")
    return Z


def check_T(T, m, n):
    """State transition: (m, m) or (m, m, n), returned (m, m, 1|n)."""
    T = np.asarray(T, dtype=np.float64)
    if T.size == 1 and m == 1:
        return T.reshape(1, 1, 1)
    if T.ndim == 2:
        T = T[..., None]
    if T.ndim != 3 or T.shape[0] != m or T.shape[1] != m or \
            T.shape[2] not in (1, n):
        raise ValueError(
            "'T' must be a (m x m) matrix, (m x m x 1) or (m x m x n) "
            "array, where m is the number of states.")
    return T


def check_R(R, m, n):
    """State noise loading: (m, k) or (m, k, n), k <= m, returned
    (m, k, 1|n)."""
    R = np.asarray(R, dtype=np.float64)
    if R.ndim <= 1 and R.size == m:
        return R.reshape(m, 1, 1)
    if R.ndim == 2:
        R = R[..., None]
    if R.ndim != 3 or R.shape[0] != m or R.shape[1] > m or \
            R.shape[2] not in (1, n):
        raise ValueError(
            "'R' must be a (m x k) matrix, (m x k x 1) or (m x k x n) "
            "array, where k<=m is the number of disturbances eta, and m is "
            "the number of states.")
    return R


def check_a1(a1, m):
    if a1 is None:
        return np.zeros(m)
    a1 = np.asarray(a1, dtype=np.float64).reshape(-1)
    if a1.size in (1, m):
        return np.broadcast_to(a1, (m,)).copy()
    raise ValueError("Misspecified a1, argument a1 must be a vector of "
                     "length m, where m is the number of states.")


def check_P1(P1, m):
    if P1 is None:
        return np.zeros((m, m))
    P1 = np.asarray(P1, dtype=np.float64)
    if P1.size == 1 and m == 1:
        return P1.reshape(1, 1)
    if P1.shape != (m, m):
        raise ValueError("Argument P1 must be (m x m) matrix, where m is "
                         "the number of states.")
    return P1


def check_H(H, p, n, multivariate=False):
    """Observation noise sd: scalar or (n,), returned 1-D; with
    ``multivariate`` a lower factor of the observation covariance, a
    scalar (times the identity), (p, p) or (p, p, n), returned
    (p, p, 1|n)."""
    H = np.asarray(H, dtype=np.float64)
    if multivariate:
        if H.ndim == 0:
            H = np.eye(p) * float(H)
        if H.ndim == 2:
            H = H[..., None]
        if H.ndim != 3 or H.shape[0] != p or H.shape[1] != p or \
                H.shape[2] not in (1, n):
            raise ValueError(
                "'H' must be p x p matrix or p x p x n array, where p is the "
                "number of series and n is the length of the series.")
        return H
    if H.size not in (1, n):
        raise ValueError("'H' must be a scalar or length n, where n is "
                         "the length of the time series y.")
    return H.reshape(-1)


def check_intmax(x, name="particles", positive=True, max=100000):
    """Bounded integer check."""
    xi = int(x)
    if xi != x or (positive and xi <= 0) or (not positive and xi < 0):
        kind = "positive" if positive else "non-negative"
        raise ValueError(f"Argument '{name}' should be a {kind} integer.")
    if xi > max:
        raise ValueError(f"You probably do not want '{name}' > {max}.")
    return xi


def check_positive_real(x, name):
    v = float(x)
    if not np.isfinite(v) or v < 0:
        raise ValueError(f"Argument '{name}' should be positive real "
                         "value.")
    return v


def check_theta(theta):
    theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
    if theta.ndim != 1:
        raise ValueError("Argument 'theta' should be a numeric vector.")
    return theta


def check_missingness(arrays, allow=("y",)):
    """NaN allowed only in y.  ``arrays``: dict of name -> array-like."""
    for name, arr in arrays.items():
        if name in allow or arr is None:
            continue
        a = np.asarray(arr, dtype=np.float64)
        if np.isnan(a).any():
            raise ValueError("Missing values not allowed in the model "
                             "object (except in component 'y').")
