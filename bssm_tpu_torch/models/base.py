"""Model objects: a batched ``build(theta) -> spec`` plus prior machinery.

Counterpart of ``bssm_tpu/models/base.py``.  A model holds
  - ``build``:      theta ``(B, d)`` -> spec whose theta-dependent leaves
                    carry the batch axis ``B`` (a ``(d,)`` theta is taken as
                    a batch of one),
  - ``log_prior``:  theta ``(..., d)`` -> ``(...)`` in the sampled space,
                    Jacobians of the log transforms included,
  - ``theta_init``: initial theta in the sampled space (numpy),
plus the device and dtype its tensors live on and the metadata used when
results are reported in the natural parameter space.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch

from ..core.priors import LOG, Prior, PriorStack
from ..core.spec import BINOMIAL, GAMMA, NEGBIN, POISSON, SVM


@dataclasses.dataclass(frozen=True)
class Model:
    build: Callable[[torch.Tensor], Any]
    log_prior: Callable[[torch.Tensor], torch.Tensor]
    theta_init: np.ndarray
    theta_names: Tuple[str, ...]
    transforms: np.ndarray            # per-theta transform code (0 id, 1 log)
    kind: str                         # 'lg', 'ng', 'mlg' or 'mng'
    extra: dict = dataclasses.field(default_factory=dict)
    # keyword-only, so that the JAX package's positional order binds
    device: torch.device = dataclasses.field(kw_only=True)
    dtype: torch.dtype = dataclasses.field(kw_only=True)

    @property
    def n_par(self) -> int:
        return int(self.theta_init.shape[0])

    def to_natural(self, theta: torch.Tensor) -> torch.Tensor:
        """Map sampled-space draws back to the natural space (exp of logged
        entries), over any leading axes."""
        is_log = torch.as_tensor(self.transforms == LOG, device=theta.device)
        return torch.where(is_log, torch.exp(theta), theta)

    def initial_S(self) -> np.ndarray:
        """Default RAM scale: diag(0.1 max(0.1, |theta|))."""
        t = np.asarray(self.theta_init)
        return np.diag(0.1 * np.maximum(0.1, np.abs(t)))


def _is_prior(x) -> bool:
    return isinstance(x, Prior) or (
        isinstance(x, list) and len(x) > 0 and isinstance(x[0], Prior))


def collect_priors(named: Sequence[Tuple[str, Any, int]]):
    """From [(name, prior_or_fixed_or_None, transform_code)] build the packed
    stack, theta_init and names; fixed/None entries are skipped."""
    flat, names, trs = [], [], []
    for name, p, tr in named:
        if p is None or not _is_prior(p):
            continue
        ps = p if isinstance(p, list) else [p]
        for i, prior in enumerate(ps):
            flat.append(prior)
            names.append(name if len(ps) == 1 else f"{name}_{i + 1}")
            trs.append(tr)
    stack = PriorStack.from_priors(flat, trs)
    inits = [prior.init for prior in flat]
    return stack, stack.init_theta(inits), tuple(names)


def init_mode(y: np.ndarray, u: np.ndarray, distribution: int) -> np.ndarray:
    """Link-scale starting signal for the Laplace iteration."""
    y = np.asarray(y, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    if distribution == POISSON:
        r = y / u
        r = np.where(np.isnan(r) | (r < 0.1), 0.1, r)
        return np.log(r)
    if distribution == BINOMIAL:
        r = (np.where(np.isnan(y), 0.5, y) + 0.5) / (u + 1.0)
        return np.log(r / (1.0 - r))
    if distribution == GAMMA:
        r = y / u
        r = np.where(np.isnan(r) | (r < 1.0), 1.0, r)
        return np.log(r)
    if distribution == NEGBIN:
        r = y / u
        r = np.where(np.isnan(r) | (r < 1.0 / 6.0), 1.0 / 6.0, r)
        return np.log(r)
    if distribution == SVM:
        r = np.where(np.isnan(y), 1e-4, np.maximum(1e-4, y * y))
        return np.log(r)
    return y.copy()
