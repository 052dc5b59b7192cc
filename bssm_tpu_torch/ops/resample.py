"""Stratified and systematic resampling and ancestor tracing, batched.

Counterpart of ``bssm_tpu/ops/resample.py``.  With normalised weights w
and uniforms r_p ~ U(0,1), particle p takes the ancestor
min{q : cumsum(w)_q >= (p + r_p)/N}, with the last cumulative weight set to
exactly 1: stratified resampling draws one r_p a particle, systematic one r
for all.  The JAX package selects with a one-hot matrix product because
its accelerator has no per-particle gather (``stratified_select``,
``stratified_gather``); here it is ``searchsorted`` and ``gather``, which
pick the same ancestors.
"""
from __future__ import annotations

from typing import Optional

import torch


def stratified_indices_from_uniforms(weights: torch.Tensor,
                                     r: torch.Tensor) -> torch.Tensor:
    """Ancestor indices ``(..., N)`` (int64) from normalised ``weights`` and
    uniforms ``r``, both ``(..., N)``."""
    N = weights.shape[-1]
    cp = torch.cumsum(weights, dim=-1)
    cp[..., -1] = 1.0
    u = (torch.arange(N, dtype=weights.dtype, device=weights.device) + r) / N
    idx = torch.searchsorted(cp, u.contiguous(), right=False)
    return torch.clamp(idx, 0, N - 1)


def stratified_indices(weights: torch.Tensor,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Stratified resampling indices ``(..., N)`` of normalised ``weights
    (..., N)``: one uniform a particle, drawn from ``generator`` on
    ``weights``' device."""
    r = torch.rand(weights.shape, dtype=weights.dtype,
                   device=weights.device, generator=generator)
    return stratified_indices_from_uniforms(weights, r)


def systematic_indices(weights: torch.Tensor,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Systematic resampling indices ``(..., N)`` of normalised ``weights
    (..., N)``: one uniform a row of weights, drawn from ``generator`` on
    ``weights``' device, shared by its N strata."""
    r = torch.rand(weights.shape[:-1] + (1,), dtype=weights.dtype,
                   device=weights.device, generator=generator)
    return stratified_indices_from_uniforms(weights, r.expand(weights.shape))


def stratified_gather_from_uniforms(weights: torch.Tensor, r: torch.Tensor,
                                    alpha: torch.Tensor) -> torch.Tensor:
    """The resampled ensemble ``alpha[..., idx, :]``; alpha ``(..., N, m)``."""
    idx = stratified_indices_from_uniforms(weights, r)
    return torch.gather(alpha, -2,
                        idx.unsqueeze(-1).expand(*idx.shape, alpha.shape[-1]))


def ancestor_trace(alpha: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Kitagawa's filter-smoother tracing: ``alpha (..., N, n+1, m)`` stored
    so that ``alpha[..., :, t+1, :]`` are the children of
    ``alpha[..., indices[..., :, t], t, :]``, ``indices (..., N, n)``.
    Returns ``(..., N, n+1, m)``: row i is the whole path that ends at
    particle i at time n.  A reverse loop composes the ancestor maps, then
    one gather picks every state."""
    N, n1, m = alpha.shape[-3:]
    b = torch.arange(N, device=indices.device).expand(indices.shape[:-1])
    lineage = [b]
    for t in range(n1 - 2, -1, -1):
        b = torch.gather(indices[..., t], -1, b)
        lineage.append(b)
    idx = torch.stack(lineage[::-1], dim=-1)                  # (..., N, n+1)
    return torch.gather(alpha, -3, idx.unsqueeze(-1).expand(
        *idx.shape, m))
