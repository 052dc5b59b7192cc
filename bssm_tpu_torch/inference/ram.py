"""Robust Adaptive Metropolis (RAM) scale adaptation (Vihola 2012), batched
over chains.  Counterpart of ``bssm_tpu/inference/ram.py``.

  S <- chol factor of  S (I + eta_n (alpha_n - alpha*) u u' / ||u||^2) S',
  eta_n = min(1, d n^{-gamma}),

as a rank-1 Cholesky update/downdate of the lower factor S with the vector
v = S u sqrt(eta_n |alpha_n - alpha*|) / ||u||.  A downdate that would
destroy positive definiteness is skipped (the chain keeps its previous S).
"""
from __future__ import annotations

import torch

from ..ops.chol import chol_rank1_update


def adapt_S(S: torch.Tensor, u: torch.Tensor, accept_prob: torch.Tensor,
            target: float, i: int, gamma: float) -> torch.Tensor:
    """S ``(C, d, d)``, u ``(C, d)``, accept_prob ``(C,)``; ``i`` is the
    1-based iteration number shared by all chains."""
    d = S.shape[-1]
    change = accept_prob - target
    unorm = torch.linalg.vector_norm(u, dim=-1)
    eta = min(1.0, d * float(i) ** (-gamma))
    scale = torch.sqrt(eta * torch.abs(change)) / torch.clamp(
        unorm, min=torch.finfo(S.dtype).tiny)
    v = (S @ u.unsqueeze(-1)).squeeze(-1) * scale.unsqueeze(-1)
    S_new = chol_rank1_update(S, v, down=change <= 0)
    diag = torch.diagonal(S_new, dim1=-2, dim2=-1)
    ok = torch.isfinite(S_new).all(dim=(-1, -2)) & (diag > 0).all(dim=-1)
    return torch.where(ok[..., None, None], S_new, S)
