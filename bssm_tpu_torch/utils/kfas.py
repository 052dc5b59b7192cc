"""KFAS ``SSModel`` ingestion: the port's ``as_bssm`` for a KFAS model.

The port's own copy of ``bssm_tpu/utils/kfas.py`` (numpy only; it builds the
port's models).  A ``KFAS::SSModel`` saved with ``saveRDS`` parses (by
``utils.rdata.load_rds``) into a named dict of arrays in KFAS layouts: y
(n,) or (n, p); Z (p, m, nt); H (p, p, nt); T (m, m, nt); R (m, k, nt); Q
(k, k, nt); a1 (m, 1); P1 / P1inf (m, m); u; distribution (a name or a
list of names).  ``as_bssm_kfas`` follows the R package's conversion
(``R/as_bssm.R``):

  - exact-diffuse initial-state elements (P1inf > 0) become a proper prior
    variance ``kappa``;
  - the state noise factor is R L sqrt(D) from the LDL of Q when Q has
    more than one column, else R sqrt(Q);
  - a multivariate Gaussian H is replaced by its LDL factor L sqrt(D);
  - per-series u / phi mapping for the non-Gaussian families: poisson and
    binomial keep u as exposure / trials; gamma and negative binomial read
    phi from u (constant only) and reset u to 1; a gaussian series inside
    an mng model reads phi = sqrt(u).
"""
from __future__ import annotations

import numpy as np


def _ldl(A: np.ndarray, tol: float = 1e-12):
    """LDL' of a PSD matrix with possible zero rows (KFAS::ldl semantics):
    unit-lower L and diagonal d; zero-pivot columns yield L column = e_j,
    d_j = 0."""
    A = np.asarray(A, np.float64)
    k = A.shape[0]
    L = np.eye(k)
    d = np.zeros(k)
    scale = max(np.abs(np.diag(A)).max(), 1.0)
    for j in range(k):
        d[j] = A[j, j] - np.sum(L[j, :j] ** 2 * d[:j])
        if d[j] > tol * scale:
            for i in range(j + 1, k):
                L[i, j] = (A[i, j]
                           - np.sum(L[i, :j] * L[j, :j] * d[:j])) / d[j]
        else:
            d[j] = max(d[j], 0.0)
    return L, d


def _ldl_factor(A: np.ndarray) -> np.ndarray:
    """L sqrt(diag(d)), the factor form the R package builds."""
    L, d = _ldl(A)
    return L * np.sqrt(d)[None, :]


def _tlast3(A, name: str) -> np.ndarray:
    """Coerce a KFAS system array to 3-D (r, c, nt)."""
    A = np.asarray(A, np.float64)
    if A.ndim == 2:
        return A[:, :, None]
    if A.ndim != 3:
        raise ValueError(f"KFAS {name} must be 2- or 3-D, got {A.shape}")
    return A


def as_bssm_kfas(model, kappa: float = 100.0, **kwargs):
    """Convert a parsed (or on-disk .rds) ``KFAS::SSModel`` into the
    matching port model: ``ssm_ulg`` / ``ssm_mlg`` / ``ssm_ung`` /
    ``ssm_mng``; ``kwargs`` (``dtype``, ``device``, ``update_fn``, ...)
    go to the constructor."""
    from ..models.ssm import ssm_mlg, ssm_mng, ssm_ulg, ssm_ung
    if isinstance(model, str):
        from .rdata import load_rds
        model = load_rds(model)
    if not isinstance(model, dict):
        raise ValueError("expected a parsed SSModel dict or an .rds path")
    if kappa <= 0:
        raise ValueError("kappa must be positive")

    y = np.asarray(model["y"], np.float64)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    p = 1 if y.ndim == 1 else y.shape[1]
    n = y.shape[0]

    Z = _tlast3(model["Z"], "Z")            # (p, m, nt)
    T = _tlast3(model["T"], "T")
    R = _tlast3(model["R"], "R")            # (m, k, nt)
    Q = _tlast3(model["Q"], "Q")            # (k, k, nt)
    a1 = np.asarray(model["a1"], np.float64).reshape(-1)
    P1 = np.array(model["P1"], np.float64, copy=True)
    if P1.ndim == 3:
        P1 = P1[:, :, 0]
    P1inf = np.asarray(model.get("P1inf", np.zeros_like(P1)), np.float64)
    if P1inf.ndim == 3:
        P1inf = P1inf[:, :, 0]
    # exact diffuse -> proper kappa prior
    P1[P1inf > 0] = kappa

    # state noise factor: R L sqrt(D) from LDL(Q)
    k = R.shape[1]
    tvr, tvq = R.shape[2] > 1, Q.shape[2] > 1
    nt_rq = n if (tvr or tvq) else 1
    if k > 1:
        Rc = np.zeros((R.shape[0], k, nt_rq))
        for i in range(nt_rq):
            Rc[:, :, i] = R[:, :, i if tvr else 0] @ _ldl_factor(
                Q[:, :, i if tvq else 0])
    else:
        q = np.sqrt(np.maximum(Q[0, 0, :], 0.0))     # (ntq,)
        Rb = R if R.shape[2] == nt_rq else np.repeat(R, nt_rq, axis=2)
        qb = q if q.shape[0] == nt_rq else np.repeat(q, nt_rq)
        Rc = Rb * qb[None, None, :]

    dist = model.get("distribution", "gaussian")
    if isinstance(dist, str):
        dist = [dist]
    dist = [str(d) for d in dist]

    if p == 1:
        Zu = Z[0]                                    # (m, nt)
        if Zu.shape[1] == 1:
            Zu = Zu[:, 0]
        if dist == ["gaussian"]:
            H = _tlast3(model["H"], "H")             # (1, 1, nt)
            Hv = np.sqrt(np.maximum(H[0, 0, :], 0.0))
            return ssm_ulg(y, Zu, Hv if Hv.shape[0] > 1 else float(Hv[0]),
                           T, Rc, a1=a1, P1=P1, **kwargs)
        u = np.asarray(model.get("u", np.ones(n)), np.float64).reshape(-1)
        d0 = dist[0]
        if d0 in ("gamma", "negative binomial"):
            if np.unique(u).size > 1:
                raise ValueError(
                    f"time-varying {'shape' if d0 == 'gamma' else 'dispersion'}"
                    f" parameter for {d0} is not supported")
            phi, u = float(u[0]), np.ones(n)
        else:
            phi = 1.0
        return ssm_ung(y, Zu, T, Rc, distribution=d0, phi=phi, u=u,
                       a1=a1, P1=P1, **kwargs)

    # multivariate
    if all(d == "gaussian" for d in dist):
        H = _tlast3(model["H"], "H")                 # (p, p, nt)
        Hc = np.stack([_ldl_factor(H[:, :, i])
                       for i in range(H.shape[2])], axis=2)
        return ssm_mlg(y, Z, Hc, T, Rc, a1=a1, P1=P1, **kwargs)
    u = np.asarray(model.get("u", np.ones((n, p))), np.float64)
    u = u.reshape(n, p)
    phi = np.zeros(p)
    u_out = np.array(u, copy=True)
    for i, d_i in enumerate(dist):
        if d_i in ("poisson", "binomial"):
            phi[i] = 1.0
        elif d_i in ("gamma", "negative binomial"):
            if np.unique(u[:, i]).size > 1:
                raise ValueError(
                    f"time-varying parameter for series {i + 1} ({d_i}) "
                    "is not supported")
            phi[i] = u[0, i]
            u_out[:, i] = 1.0
        elif d_i == "gaussian":
            if np.unique(u[:, i]).size > 1:
                raise ValueError(
                    "time-varying standard deviation for a gaussian series "
                    "in an mng model is not supported")
            phi[i] = np.sqrt(u[0, i])
            u_out[:, i] = 1.0
        else:
            raise ValueError(f"unknown KFAS distribution {d_i!r}")
    return ssm_mng(y, Z, T, Rc, distributions=dist, phi=phi, u=u_out,
                   a1=a1, P1=P1, **kwargs)
