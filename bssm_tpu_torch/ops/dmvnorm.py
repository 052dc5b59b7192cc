"""Multivariate normal log-densities tolerant of singular covariances.

Counterpart of ``bssm_tpu/ops/dmvnorm.py``, batched over any leading axes:
the density is restricted to the subspace of nonzero diagonal entries
(deterministic state components contribute nothing), masked instead of
sliced.
"""
from __future__ import annotations

import torch

from .chol import masked_chol, masked_tri_solve

LOG2PI = 1.8378770664093453
_EPS = 2.220446049250313e-16


def dmvnorm(x: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor,
            lwr: bool = False) -> torch.Tensor:
    """log N(x; mean, cov) over the last axis, ``(...)``; with ``lwr``
    ``cov`` is already a (possibly padded) lower factor L with cov = L L'.
    Dimensions with a zero diagonal are left out."""
    if lwr:
        L = cov
        active = torch.diagonal(L, dim1=-2, dim2=-1) > _EPS
    else:
        active = torch.diagonal(cov, dim1=-2, dim2=-1) > _EPS
        L = masked_chol(cov, active)
    am = active.to(x.dtype)
    z = masked_tri_solve(L, (x - mean) * am, active)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    logdet = torch.where(active, torch.log(torch.where(
        active, diag, torch.ones_like(diag))), torch.zeros_like(diag))
    return -0.5 * (am.sum(-1) * LOG2PI + (z * z).sum(-1)) - logdet.sum(-1)
