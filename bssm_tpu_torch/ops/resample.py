"""Stratified resampling from caller-supplied uniforms, batched.

Counterpart of ``bssm_tpu/ops/resample.py:102-139``.  With normalised
weights w and uniforms r_p ~ U(0,1), particle p takes the ancestor
min{q : cumsum(w)_q >= (p + r_p)/N}, with the last cumulative weight set to
exactly 1.  The JAX package selects with a one-hot matrix product because
its accelerator has no per-particle gather; here it is ``searchsorted`` and
``gather``, which pick the same ancestors.
"""
from __future__ import annotations

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


def stratified_gather_from_uniforms(weights: torch.Tensor, r: torch.Tensor,
                                    alpha: torch.Tensor) -> torch.Tensor:
    """The resampled ensemble ``alpha[..., idx, :]``; alpha ``(..., N, m)``."""
    idx = stratified_indices_from_uniforms(weights, r)
    return torch.gather(alpha, -2,
                        idx.unsqueeze(-1).expand(*idx.shape, alpha.shape[-1]))
