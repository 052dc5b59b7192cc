"""General state-space models with user update functions.

Counterpart of ``ssm_ulg``, ``ssm_ung``, ``ssm_mlg`` and ``ssm_mng`` in
``bssm_tpu/models/ssm.py``.  The system arrays come in the R package's
layout, the time axis last of size 1 or n (Z ``(m, 1|n)``, T ``(m, m,
1|n)``, R ``(m, k, 1|n)``, C ``(m, 1|n)``, H and D scalars or length n;
with p series Z ``(p, m, 1|n)``, H ``(p, p, 1|n)`` a lower factor of the
observation covariance, D ``(p, 1|n)``), and are normalised to the spec's,
time axis first (``core/spec.py``).

The user functions are torch functions batched over chains, as ``build``
is: ``update_fn(theta)`` takes theta ``(B, d)`` and returns a dict of spec
leaves to replace, each in the spec's layout (time axis first, of size 1
or n, where the leaf has one) with or without the leading batch axis B;
``prior_fn(theta)`` takes ``(B, d)`` and returns the log prior density
``(B,)`` (default 0).  theta is sampled untransformed.  A leaf with a time
axis of n in Z, T, R or C takes the models outside the kernels' contract
to the plain versions (``ops/cuda_kalman.kernel_takes``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import validate as val
from ..core.config import DEFAULT_DTYPE, resolve_device
from ..core.spec import (LGSpec, MVLGSpec, MVNGSpec, NGSpec, _replace,
                         core_ndim)
from .base import Model, init_mode
from .bsm import _DIST_NAMES

# the leaves whose first core axis is time (size 1 or n)
_TIMED = ("Z", "H", "T", "R", "D", "C")


def _system(Z, H, T, R, a1, P1, D, C, n, dev):
    """The R-layout arrays checked and moved to the spec's layout, as
    tensors by ``dev``; returns (m, dict of leaves)."""
    Z = val.check_Z(Z, 1, n)                            # (m, 1|n)
    m = Z.shape[0]
    arrays = {"Z": Z.T, "H": val.check_H(H, 1, n),
              "T": np.moveaxis(val.check_T(T, m, n), -1, 0),
              "R": np.moveaxis(val.check_R(R, m, n), -1, 0),
              "a1": val.check_a1(a1, m), "P1": val.check_P1(P1, m),
              "D": val.check_D(D, 1, n), "C": val.check_C(C, m, n).T}
    val.check_missingness(arrays)
    return m, {k: dev(v) for k, v in arrays.items()}


def _system_mv(Z, H, T, R, a1, P1, D, C, n, p, dev):
    """``_system`` for p series: Z ``(p, m, 1|n)``, H ``(p, p, 1|n)``
    (None for a non-Gaussian model) and D ``(p, 1|n)``, moved to the
    spec's layout."""
    Z = val.check_Z(Z, p, n, multivariate=True)
    m = Z.shape[1]
    arrays = {"Z": np.moveaxis(Z, -1, 0),
              "T": np.moveaxis(val.check_T(T, m, n), -1, 0),
              "R": np.moveaxis(val.check_R(R, m, n), -1, 0),
              "a1": val.check_a1(a1, m), "P1": val.check_P1(P1, m),
              "D": np.atleast_2d(val.check_D(D, p, n)).T,
              "C": val.check_C(C, m, n).T}
    if H is not None:
        arrays["H"] = np.moveaxis(
            val.check_H(H, p, n, multivariate=True), -1, 0)
    val.check_missingness(arrays)
    return m, {k: dev(v) for k, v in arrays.items()}


def _make_model(base, update_fn, prior_fn, init_theta, kind, extra,
                names, device, dtype) -> Model:
    theta0 = np.atleast_1d(np.asarray(init_theta, dtype=np.float64))
    d, n = theta0.shape[0], base.n

    core_of = core_ndim(base)

    def leaf(k, v, B):
        if k not in core_of or not hasattr(base, k):
            raise ValueError(f"update_fn returned an unknown leaf {k!r}")
        v = torch.as_tensor(v, dtype=dtype, device=device)
        c, cur = core_of[k], getattr(base, k)
        core = tuple(v.shape[v.dim() - c:])
        want = tuple(cur.shape[cur.dim() - c:])
        if k in _TIMED:
            fits = core[1:] == want[1:] and core[0] in (1, n)
        else:
            fits = core == want
        if v.dim() not in (c, c + 1) or not fits or (
                v.dim() == c + 1 and v.shape[0] != B):
            raise ValueError(
                f"update_fn: {k} has shape {tuple(v.shape)}; expected "
                f"{want}" + (" (time axis 1 or n)" if k in _TIMED else "")
                + f", with or without a leading batch axis of {B}")
        return v

    def build(theta: torch.Tensor):
        theta = torch.atleast_2d(theta).to(dtype)
        if update_fn is None:
            return base
        new = {k: leaf(k, v, theta.shape[0])
               for k, v in update_fn(theta).items()}
        return _replace(base, **new)

    def no_prior(theta: torch.Tensor) -> torch.Tensor:
        return torch.zeros(theta.shape[:-1], dtype=theta.dtype,
                           device=theta.device)

    if names is None:
        names = tuple(f"theta_{i + 1}" for i in range(d))
    return Model(build=build, log_prior=prior_fn or no_prior,
                 theta_init=theta0, theta_names=tuple(names),
                 transforms=np.zeros(d, np.int32), kind=kind, device=device,
                 dtype=dtype, extra=extra)


def ssm_ulg(y, Z, H, T, R, a1=None, P1=None, D=None, C=None,
            init_theta=(), update_fn: Optional[Callable] = None,
            prior_fn: Optional[Callable] = None, theta_names=None,
            dtype: torch.dtype = DEFAULT_DTYPE, device=None) -> Model:
    """Univariate linear-Gaussian model; ``H`` is the observation sd.
    ``device=None`` means the CUDA device (raises when there is none)."""
    device = resolve_device(device)
    y_np = val.check_y(y)
    n = y_np.shape[0]

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    m, sysm = _system(Z, H, T, R, a1, P1, D, C, n, dev)
    spec = LGSpec(y=dev(y_np), **sysm)
    return _make_model(spec, update_fn, prior_fn, init_theta, "lg",
                       {"m": m, "n": n}, theta_names, device, dtype)


def ssm_ung(y, Z, T, R, distribution, phi=1.0, u=None, a1=None, P1=None,
            D=None, C=None, init_theta=(), update_fn=None, prior_fn=None,
            theta_names=None, dtype: torch.dtype = DEFAULT_DTYPE,
            device=None) -> Model:
    """Univariate non-Gaussian model of one of the families of ``bsm_ng``
    (or ``"svm"``); ``phi`` and ``u`` as there.  ``device=None`` means the
    CUDA device (raises when there is none)."""
    device = resolve_device(device)
    dist = _DIST_NAMES[distribution] if isinstance(distribution, str) \
        else int(distribution)
    y_np = val.check_y(y, distribution=distribution
                       if isinstance(distribution, str) else None)
    n = y_np.shape[0]
    u_np = np.ones(n) if u is None else val.check_u(u, y_np)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    m, sysm = _system(Z, 1.0, T, R, a1, P1, D, C, n, dev)
    del sysm["H"]
    spec = NGSpec(y=dev(y_np), **sysm, phi=dev(float(phi)), u=dev(u_np),
                  distribution=dist,
                  initial_mode=dev(init_mode(y_np, u_np, dist)))
    return _make_model(spec, update_fn, prior_fn, init_theta, "ng",
                       {"m": m, "n": n, "distribution": dist}, theta_names,
                       device, dtype)


def ssm_mlg(y, Z, H, T, R, a1=None, P1=None, D=None, C=None,
            init_theta=(), update_fn: Optional[Callable] = None,
            prior_fn: Optional[Callable] = None, theta_names=None,
            dtype: torch.dtype = DEFAULT_DTYPE, device=None) -> Model:
    """Multivariate linear-Gaussian model of p series, y ``(n, p)`` (NaN
    where a series is missing); ``H`` a lower factor of the observation
    covariance.  ``device=None`` means the CUDA device (raises when there
    is none)."""
    device = resolve_device(device)
    y_np = val.check_y(y, multivariate=True)
    n, p = y_np.shape

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    m, sysm = _system_mv(Z, H, T, R, a1, P1, D, C, n, p, dev)
    spec = MVLGSpec(y=dev(y_np), **sysm)
    return _make_model(spec, update_fn, prior_fn, init_theta, "mlg",
                       {"m": m, "n": n, "p": p}, theta_names, device, dtype)


def ssm_mng(y, Z, T, R, distributions, phi=None, u=None, a1=None, P1=None,
            D=None, C=None, init_theta=(), update_fn=None, prior_fn=None,
            theta_names=None, dtype: torch.dtype = DEFAULT_DTYPE,
            device=None) -> Model:
    """Multivariate non-Gaussian model of p series, y ``(n, p)``, each of
    its own family (``distributions``: one name or int for all, or one
    per series; "gaussian" has the sd ``phi[j]``); ``phi`` ``(p,)`` and
    ``u`` ``(n, p)`` broadcast.  The Laplace iteration starts from each
    series' own data-derived mode.  ``device=None`` means the CUDA device
    (raises when there is none)."""
    device = resolve_device(device)
    y_np = val.check_y(y, multivariate=True)
    n, p = y_np.shape
    if isinstance(distributions, (str, int)):
        distributions = [distributions] * p
    if all(isinstance(d, str) for d in distributions):
        val.check_distribution(y_np, list(distributions))
    dists = tuple(_DIST_NAMES[d] if isinstance(d, str) else int(d)
                  for d in distributions)
    u_np = np.ones((n, p)) if u is None else np.broadcast_to(
        np.asarray(u, np.float64), (n, p)).copy()
    if (u_np <= 0).any() or not np.isfinite(u_np).all():
        raise ValueError("Argument 'u' must contain only positive finite "
                         "values.")
    phi_np = np.ones(p) if phi is None else np.broadcast_to(
        np.asarray(phi, np.float64), (p,)).copy()

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    m, sysm = _system_mv(Z, None, T, R, a1, P1, D, C, n, p, dev)
    mode0 = np.stack([init_mode(y_np[:, j], u_np[:, j], dists[j])
                      for j in range(p)], axis=1)
    spec = MVNGSpec(y=dev(y_np), **sysm, phi=dev(phi_np), u=dev(u_np),
                    distributions=dists, initial_mode=dev(mode0))
    return _make_model(spec, update_fn, prior_fn, init_theta, "mng",
                       {"m": m, "n": n, "p": p, "distributions": dists},
                       theta_names, device, dtype)


def as_bssm(y, Z=None, H=None, T=None, R=None, a1=None, P1=None, D=None,
            C=None, distribution=None, phi=1.0, u=None, kappa: float = 100.0,
            **kwargs) -> Model:
    """The port model of a KFAS ``SSModel``, a parsed dict or the path of
    an ``.rds`` file written by ``saveRDS`` (``utils/kfas.as_bssm_kfas``:
    diffuse initial states get the variance ``kappa``, Q and a
    multivariate H are re-factorised by LDL), or of raw system matrices in
    the R package's layout: ``ssm_ulg`` (one series, ``H`` the sd),
    ``ssm_mlg`` (several, ``H`` a lower factor), or with ``distribution``
    ``ssm_ung`` / ``ssm_mng``.  ``kwargs`` (``dtype``, ``device``,
    ``update_fn``, ``prior_fn``, ``init_theta``, ...) go to the
    constructor; ``device=None`` means the CUDA device."""
    if isinstance(y, (str, dict)):
        from ..utils.kfas import as_bssm_kfas
        return as_bssm_kfas(y, kappa=kappa, **kwargs)
    if Z is None or H is None and distribution is None or T is None \
            or R is None:
        raise ValueError("as_bssm needs an SSModel (dict or .rds path) or "
                         "the full Z / H / T / R system")
    y_np = np.asarray(y, np.float64)
    multivariate = y_np.ndim == 2 and y_np.shape[1] > 1
    if distribution is None:
        make = ssm_mlg if multivariate else ssm_ulg
        return make(y, Z, H, T, R, a1=a1, P1=P1, D=D, C=C, **kwargs)
    if multivariate:
        return ssm_mng(y, Z, T, R, distributions=distribution, phi=phi, u=u,
                       a1=a1, P1=P1, D=D, C=C, **kwargs)
    return ssm_ung(y, Z, T, R, distribution=distribution, phi=phi, u=u,
                   a1=a1, P1=P1, D=D, C=C, **kwargs)
