"""State carried across from numpy (and so from the JAX package, whose
arrays a caller converts with ``np.asarray``) into this package's tensors.

The dictionaries use the JAX package's field names; a leading batch axis on
any leaf is optional.  Nothing here imports JAX: the caller hands over plain
numpy arrays.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .core.config import DEFAULT_DTYPE, resolve_device
from .core.spec import (LGSpec, MVLGSpec, MVNGSpec, NGSpec, POISSON,
                        with_batch)
from .inference.approx import ApproxLoglik, ApproxResult
from .inference.nlg import NLGApprox


def _tensor(x, device, dtype) -> torch.Tensor:
    # np.array copies: the source may be a read-only view of foreign memory
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _leaves(d: Mapping, names, device, dtype) -> dict:
    missing = [k for k in names if k not in d]
    if missing:
        raise KeyError(f"missing spec fields: {missing}")
    return {k: _tensor(d[k], device, dtype) for k in names}


def lgspec_from_numpy(d: Mapping, device=None,
                      dtype: torch.dtype = DEFAULT_DTYPE) -> LGSpec:
    """``LGSpec`` from arrays ``y, Z, H, T, R, a1, P1, D, C``."""
    device = resolve_device(device)
    return LGSpec(**_leaves(d, LGSpec._fields, device, dtype))


def ngspec_from_numpy(d: Mapping, device=None,
                      dtype: torch.dtype = DEFAULT_DTYPE) -> NGSpec:
    """``NGSpec`` from arrays ``y, Z, T, R, a1, P1, D, C, phi, u`` plus the
    int ``distribution`` and, optionally, ``initial_mode``."""
    device = resolve_device(device)
    names = ("y", "Z", "T", "R", "a1", "P1", "D", "C", "phi", "u")
    leaves = _leaves(d, names, device, dtype)
    mode: Optional[torch.Tensor] = None
    if d.get("initial_mode") is not None:
        mode = _tensor(d["initial_mode"], device, dtype)
    return NGSpec(**leaves, distribution=int(d.get("distribution", POISSON)),
                  initial_mode=mode)


def mvlgspec_from_numpy(d: Mapping, device=None,
                        dtype: torch.dtype = DEFAULT_DTYPE) -> MVLGSpec:
    """``MVLGSpec`` from arrays ``y (n, p), Z, H, T, R, a1, P1, D, C`` (the
    JAX package's multivariate layout)."""
    device = resolve_device(device)
    return MVLGSpec(**_leaves(d, MVLGSpec._fields, device, dtype))


def mvngspec_from_numpy(d: Mapping, device=None,
                        dtype: torch.dtype = DEFAULT_DTYPE) -> MVNGSpec:
    """``MVNGSpec`` from arrays ``y (n, p), Z, T, R, a1, P1, D, C, phi (p,),
    u (n, p)``, the tuple of ints ``distributions`` and, optionally,
    ``initial_mode (n, p)``."""
    device = resolve_device(device)
    names = ("y", "Z", "T", "R", "a1", "P1", "D", "C", "phi", "u")
    leaves = _leaves(d, names, device, dtype)
    mode: Optional[torch.Tensor] = None
    if d.get("initial_mode") is not None:
        mode = _tensor(d["initial_mode"], device, dtype)
    return MVNGSpec(**leaves, distributions=tuple(
        int(x) for x in d["distributions"]), initial_mode=mode)


def mv_approx_from_numpy(d: Mapping, device=None,
                         dtype: torch.dtype = DEFAULT_DTYPE) -> ApproxLoglik:
    """The multivariate ``approx_from_numpy``: ``mode, ytilde, Htilde``
    ``(n, p)`` or ``(B, n, p)`` and ``scales`` (summed over the series)
    ``(n,)`` or ``(B, n)``, with zero log-likelihood terms."""
    device = resolve_device(device)
    t = {k: with_batch(_tensor(d[k], device, dtype), 2)
         for k in ("mode", "ytilde", "Htilde")}
    B = t["mode"].shape[0]
    zero = torch.zeros(B, dtype=dtype, device=device)
    ar = ApproxResult(t["mode"], t["ytilde"], t["Htilde"],
                      torch.ones(B, dtype=torch.int32, device=device),
                      zero, None)
    scales = with_batch(_tensor(d["scales"], device, dtype), 1)
    return ApproxLoglik(ar, scales, zero, zero)


def nlg_approx_from_numpy(d: Mapping, device=None,
                          dtype: torch.dtype = DEFAULT_DTYPE) -> NLGApprox:
    """A nonlinear model's mode approximation (the JAX package's
    ``NLGApprox``): ``mode (n, m)``, ``approx`` a mapping of the linearised
    ``MVLGSpec``'s arrays (``y (n, p)`` shared, the others with or without
    the batch axis), ``scales (n,)``, ``loglik`` and ``niter``, each with or
    without a leading batch axis B."""
    device = resolve_device(device)
    mode = with_batch(_tensor(d["mode"], device, dtype), 2)
    B = mode.shape[0]
    g = mvlgspec_from_numpy(d["approx"], device, dtype)
    lead = lambda x: x.reshape(-1).expand(B)                 # noqa: E731
    return NLGApprox(mode, g,
                     with_batch(_tensor(d["scales"], device, dtype), 1),
                     lead(_tensor(d["loglik"], device, dtype)),
                     lead(_tensor(d["niter"], device, torch.int32)))


def approx_from_numpy(d: Mapping, device=None,
                      dtype: torch.dtype = DEFAULT_DTYPE) -> ApproxLoglik:
    """``ApproxLoglik`` from arrays ``mode, ytilde, Htilde, scales`` (each
    ``(n,)`` or ``(B, n)``) with zero log-likelihood terms: what the
    log-weight-only correction consumes."""
    device = resolve_device(device)
    t = {k: torch.atleast_2d(_tensor(d[k], device, dtype))
         for k in ("mode", "ytilde", "Htilde", "scales")}
    B = t["mode"].shape[0]
    zero = torch.zeros(B, dtype=dtype, device=device)
    ar = ApproxResult(t["mode"], t["ytilde"], t["Htilde"],
                      torch.ones(B, dtype=torch.int32, device=device),
                      zero, None)
    return ApproxLoglik(ar, t["scales"], zero, zero)


def model_state_from_numpy(theta, S, device=None,
                           dtype: torch.dtype = DEFAULT_DTYPE):
    """Chain state ``(theta (C, d), S (C, d, d))`` as tensors; a single
    chain's ``(d,)`` and ``(d, d)`` get the chain axis."""
    device = resolve_device(device)
    theta = torch.atleast_2d(_tensor(theta, device, dtype))
    S = _tensor(S, device, dtype)
    if S.dim() == 2:
        S = S.expand(theta.shape[0], -1, -1).contiguous()
    return theta, S


def particle_streams_from_numpy(eps, us, device=None,
                                dtype: torch.dtype = DEFAULT_DTYPE):
    """The injected randomness of the JAX package's large-ensemble kernels
    in this package's layout.  The JAX package keeps particles innermost and
    pads the uniforms with an unused leading row block:

    - psi mode: ``eps (B, n+1, m, N)``, ``us (B, n+1, N)``
      -> ``eps (B, n+1, N, m)``, ``us (B, n, N)``;
    - bootstrap mode: ``eps (B, n, m, N)``, ``us (B, n, N)``
      -> ``eps (B, n, N, m)``, ``us (B, n-1, N)``."""
    device = resolve_device(device)
    eps = np.ascontiguousarray(np.swapaxes(np.asarray(eps), -1, -2))
    us = np.ascontiguousarray(np.asarray(us)[:, 1:])
    return _tensor(eps, device, dtype), _tensor(us, device, dtype)
