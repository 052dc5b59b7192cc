"""Stochastic volatility model.

Counterpart of ``bssm_tpu/models/svm.py``.  Two parameterisations:
  svm_type 0 ("sigma"): y_t = sigma exp(alpha_t / 2) e_t, theta = (rho,
      sd_ar, sigma), phi = sigma;
  svm_type 1 ("mu"):    y_t = exp(alpha_t / 2) e_t, the state has mean mu,
      theta = (rho, sd_ar, mu).
State: alpha_{t+1} = mu (1 - rho) + rho alpha_t + sd_ar eta_t,
alpha_1 ~ N(mu or 0, sd_ar^2 / (1 - rho^2)).  theta is sampled
untransformed, so every leaf but y, Z, D and u carries the batch axis of
``build``'s theta (a1 and C only in the "mu" type).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.config import DEFAULT_DTYPE, resolve_device
from ..core.priors import IDENTITY
from ..core.spec import NGSpec, SVM
from ..core.validate import check_y
from .base import Model, collect_priors, init_mode


def svm(y, rho, sd_ar, sigma=None, mu=None,
        dtype: torch.dtype = DEFAULT_DTYPE, device=None) -> Model:
    """Give exactly one of ``sigma`` (svm_type 0) and ``mu`` (svm_type 1).
    ``device=None`` means the CUDA device (raises when there is none)."""
    if (sigma is None) == (mu is None):
        raise ValueError("provide exactly one of sigma (svm_type=0) "
                         "or mu (svm_type=1)")
    device = resolve_device(device)
    svm_type = 1 if sigma is None else 0
    y = check_y(y)
    n = y.shape[0]

    stack, theta0, names = collect_priors([
        ("rho", rho, IDENTITY),
        ("sd_ar", sd_ar, IDENTITY),
        ("sigma" if svm_type == 0 else "mu",
         sigma if svm_type == 0 else mu, IDENTITY),
    ])

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    yj, uj, modej = dev(y), dev(np.ones(n)), \
        dev(init_mode(y, np.ones(n), SVM))
    Zj, Dj, zero_a1, zero_C = dev(np.ones((1, 1))), dev(np.zeros(1)), \
        dev(np.zeros(1)), dev(np.zeros((1, 1)))
    one = torch.ones((), dtype=dtype, device=device)

    def build(theta: torch.Tensor) -> NGSpec:
        theta = torch.atleast_2d(theta).to(dtype)
        B = theta.shape[0]
        rho_v, sd, third = theta[:, 0], theta[:, 1], theta[:, 2]
        if svm_type == 0:
            phi, a1, C = third, zero_a1, zero_C
        else:
            phi, a1 = one, third[:, None]
            C = (third * (1.0 - rho_v)).reshape(B, 1, 1)
        return NGSpec(
            y=yj, Z=Zj, T=rho_v.reshape(B, 1, 1, 1),
            R=sd.reshape(B, 1, 1, 1), a1=a1,
            P1=(sd * sd / (1.0 - rho_v * rho_v)).reshape(B, 1, 1),
            D=Dj, C=C, phi=phi, u=uj, distribution=SVM,
            initial_mode=modej)

    return Model(build=build, log_prior=stack.bound(device, dtype),
                 theta_init=theta0, theta_names=names,
                 transforms=stack.transforms, kind="ng", device=device,
                 dtype=dtype,
                 extra={"m": 1, "n": n, "stack": stack, "distribution": SVM,
                        "svm_type": svm_type})
