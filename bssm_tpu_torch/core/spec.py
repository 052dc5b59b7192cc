"""Model-specification containers of tensors, batch first.

Counterpart of ``bssm_tpu/core/spec.py``.  The conventions of the system
matrices carry over: every matrix has a "time" axis of size 1 (time
invariant) or ``n`` (time varying), and ``y`` uses NaN for a missing
observation.  What differs is batching: where the JAX package maps a
function over specs with ``vmap``, here every leaf may carry one explicit
leading batch axis ``B`` (chains in the MCMC phase, stored draws in the
importance-sampling correction).  Leaves that do not depend on theta
(``y``, ``u``, ``Z``, ``T``, ``C``, ``a1``, ``initial_mode``) may stay
unbatched and broadcast against the batched ones.

==========  ==================  =====================
field       unbatched shape     batched shape
==========  ==================  =====================
``y``       ``(n,)``            ``(B, n)``
``Z``       ``(nz, m)``         ``(B, nz, m)``
``H``       ``(nh,)``           ``(B, nh)``
``T``       ``(nt, m, m)``      ``(B, nt, m, m)``
``R``       ``(nr, m, k)``      ``(B, nr, m, k)``
``a1``      ``(m,)``            ``(B, m)``
``P1``      ``(m, m)``          ``(B, m, m)``
``D``       ``(nd,)``           ``(B, nd)``
``C``       ``(nc, m)``         ``(B, nc, m)``
``phi``     ``()``              ``(B,)``
``u``       ``(n,)``            ``(B, n)``
==========  ==================  =====================

The multivariate specs (``MVLGSpec``, ``MVNGSpec``) hold ``p`` series:
``y (n, p)``, ``Z (nz, p, m)``, ``H (nh, p, p)`` (a lower factor, the
observation covariance is H H'), ``D (nd, p)``, ``phi (p,)``, ``u (n, p)``
and ``initial_mode (n, p)``, each with or without the leading ``B``
(``MV_CORE_NDIM``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

# Observation-family codes (the same integers as the JAX package).
SVM = 0
POISSON = 1
BINOMIAL = 2
NEGBIN = 3
GAMMA = 4
GAUSSIAN = 5

# number of trailing (non-batch) axes of each leaf
CORE_NDIM = dict(y=1, Z=2, H=1, T=3, R=3, a1=1, P1=2, D=1, C=2, phi=0, u=1,
                 initial_mode=1)
MV_CORE_NDIM = dict(CORE_NDIM, y=2, Z=3, H=3, D=2, phi=1, u=2,
                    initial_mode=2)


def with_batch(x: torch.Tensor, core_ndim: int) -> torch.Tensor:
    """View ``x`` with exactly one leading batch axis (size 1 if it had
    none), so that batched and shared leaves broadcast against each other."""
    if x.dim() == core_ndim:
        return x.unsqueeze(0)
    if x.dim() != core_ndim + 1:
        raise ValueError(f"expected {core_ndim} or {core_ndim + 1} axes, "
                         f"got shape {tuple(x.shape)}")
    return x


def at_t(A: torch.Tensor, t: int) -> torch.Tensor:
    """Index the time axis (axis 1 of a ``with_batch`` view); a size-1 axis
    broadcasts to every t."""
    return A[:, 0] if A.shape[1] == 1 else A[:, t]


def _batch_of(leaves, core=CORE_NDIM) -> Optional[int]:
    B = None
    for name, x in leaves:
        if x is None or x.dim() == core[name]:
            continue
        b = x.shape[0]
        if B is not None and b != B and 1 not in (b, B):
            raise ValueError(f"batch sizes disagree: {B} vs {b} ({name})")
        B = b if B is None else max(B, b)
    return B


class LGSpec(NamedTuple):
    """Univariate-observation linear-Gaussian state-space model."""
    y: torch.Tensor
    Z: torch.Tensor
    H: torch.Tensor
    T: torch.Tensor
    R: torch.Tensor
    a1: torch.Tensor
    P1: torch.Tensor
    D: torch.Tensor
    C: torch.Tensor

    @property
    def n(self) -> int:
        return self.y.shape[-1]

    @property
    def m(self) -> int:
        return self.a1.shape[-1]

    @property
    def k(self) -> int:
        return self.R.shape[-1]

    @property
    def batch(self) -> Optional[int]:
        """Batch size, or None when no leaf is batched."""
        return _batch_of(zip(self._fields, self))

    @property
    def HH(self) -> torch.Tensor:
        return self.H * self.H

    @property
    def RR(self) -> torch.Tensor:
        return self.R @ self.R.transpose(-1, -2)

    @property
    def obs_mask(self) -> torch.Tensor:
        return torch.isfinite(self.y)


class MVLGSpec(NamedTuple):
    """Multivariate-observation linear-Gaussian state-space model; ``H`` is
    a lower factor of the observation covariance.  A series may be missing
    at some time points and observed at others (NaN in ``y``)."""
    y: torch.Tensor
    Z: torch.Tensor
    H: torch.Tensor
    T: torch.Tensor
    R: torch.Tensor
    a1: torch.Tensor
    P1: torch.Tensor
    D: torch.Tensor
    C: torch.Tensor

    @property
    def n(self) -> int:
        return self.y.shape[-2]

    @property
    def p(self) -> int:
        return self.y.shape[-1]

    @property
    def m(self) -> int:
        return self.a1.shape[-1]

    @property
    def k(self) -> int:
        return self.R.shape[-1]

    @property
    def batch(self) -> Optional[int]:
        return _batch_of(zip(self._fields, self), MV_CORE_NDIM)

    @property
    def HH(self) -> torch.Tensor:
        return self.H @ self.H.transpose(-1, -2)

    @property
    def RR(self) -> torch.Tensor:
        return self.R @ self.R.transpose(-1, -2)

    @property
    def obs_mask(self) -> torch.Tensor:
        return torch.isfinite(self.y)


class Replaceable:
    """``spec.replace(**updates)`` of the JAX package's dataclass specs."""

    def replace(self, **updates):
        """A copy with the fields ``updates`` names replaced."""
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass(frozen=True)
class NGSpec(Replaceable):
    """Univariate non-Gaussian model: linear-Gaussian state dynamics and
    exponential-family observations.  ``distribution`` is a plain int,
    ``phi`` the auxiliary parameter (SV sigma, negbin dispersion, gamma
    shape), ``u`` the exposure or number of trials."""
    y: torch.Tensor
    Z: torch.Tensor
    T: torch.Tensor
    R: torch.Tensor
    a1: torch.Tensor
    P1: torch.Tensor
    D: torch.Tensor
    C: torch.Tensor
    phi: torch.Tensor
    u: torch.Tensor
    distribution: int = POISSON
    initial_mode: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.y.shape[-1]

    @property
    def m(self) -> int:
        return self.a1.shape[-1]

    @property
    def k(self) -> int:
        return self.R.shape[-1]

    @property
    def batch(self) -> Optional[int]:
        names = ("y", "Z", "T", "R", "a1", "P1", "D", "C", "phi", "u")
        return _batch_of((f, getattr(self, f)) for f in names)

    @property
    def obs_mask(self) -> torch.Tensor:
        return torch.isfinite(self.y)

    def approx_gaussian(self, ytilde: torch.Tensor,
                        Htilde: torch.Tensor) -> LGSpec:
        """The approximating LG model sharing this model's state dynamics."""
        return LGSpec(y=ytilde, Z=self.Z, H=Htilde, T=self.T, R=self.R,
                      a1=self.a1, P1=self.P1, D=self.D, C=self.C)


@dataclasses.dataclass(frozen=True)
class MVNGSpec(Replaceable):
    """Multivariate non-Gaussian model: linear-Gaussian state dynamics and
    ``p`` observed series, each of its own family (``distributions``, a
    tuple of the ints above; ``GAUSSIAN`` with sd ``phi[j]`` included),
    with ``phi (p,)`` and ``u (n, p)`` per series."""
    y: torch.Tensor
    Z: torch.Tensor
    T: torch.Tensor
    R: torch.Tensor
    a1: torch.Tensor
    P1: torch.Tensor
    D: torch.Tensor
    C: torch.Tensor
    phi: torch.Tensor
    u: torch.Tensor
    distributions: tuple = ()
    initial_mode: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.y.shape[-2]

    @property
    def p(self) -> int:
        return self.y.shape[-1]

    @property
    def m(self) -> int:
        return self.a1.shape[-1]

    @property
    def k(self) -> int:
        return self.R.shape[-1]

    @property
    def batch(self) -> Optional[int]:
        names = ("y", "Z", "T", "R", "a1", "P1", "D", "C", "phi", "u")
        return _batch_of(((f, getattr(self, f)) for f in names),
                         MV_CORE_NDIM)

    @property
    def obs_mask(self) -> torch.Tensor:
        return torch.isfinite(self.y)

    def approx_gaussian(self, ytilde: torch.Tensor,
                        Htilde: torch.Tensor) -> MVLGSpec:
        """The approximating multivariate LG model: ``Htilde (..., n, p)``,
        the pseudo-observations' sds, becomes the diagonal factor
        ``(..., n, p, p)``."""
        return MVLGSpec(y=ytilde, Z=self.Z, H=torch.diag_embed(Htilde),
                        T=self.T, R=self.R, a1=self.a1, P1=self.P1,
                        D=self.D, C=self.C)


def is_mv(spec) -> bool:
    """Whether ``spec`` holds several observed series."""
    return isinstance(spec, (MVLGSpec, MVNGSpec))


def core_ndim(spec) -> dict:
    """The number of trailing (non-batch) axes of each leaf of ``spec``."""
    return MV_CORE_NDIM if is_mv(spec) else CORE_NDIM


def _replace(spec, **new):
    if isinstance(spec, tuple):             # the NamedTuple specs
        return spec._replace(**new)
    return dataclasses.replace(spec, **new)


def _fields(spec):
    return spec._fields if isinstance(spec, tuple) \
        else [f.name for f in dataclasses.fields(spec)]


def drop_batch(spec):
    """The one model of a spec with a batch of one, every leaf's batch axis
    dropped: the unbatched form in which the single-model functions take
    it (the JAX package hands them one model the same way)."""
    core = core_ndim(spec)
    names = [f for f in _fields(spec) if f in core and f != "initial_mode"]
    if spec.batch not in (None, 1):
        raise ValueError(f"a batch of {spec.batch} models is not one model")
    new = {}
    for f in names:
        x = getattr(spec, f)
        if x.dim() == core[f] + 1:
            new[f] = x[0]
    return _replace(spec, **new)
