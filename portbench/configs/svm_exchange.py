"""The ``svm_exchange`` configuration: its series, the port's model built
from ``svm_exchange.json`` through the public constructor, and the plain
system that the reference evaluates.  Imports nothing of the program: the
port's package is handed in."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.ssm import System


def series(cfg: dict) -> np.ndarray:
    """The simulated returns of ``cfg["series"]``'s recipe."""
    n = cfg["n"]
    rng = np.random.default_rng(cfg["series"]["numpy_seed"])
    rho, sd_ar, sigma = 0.98, 0.15, 0.6
    h = np.empty(n)
    h[0] = rng.normal(0.0, sd_ar / np.sqrt(1.0 - rho ** 2))
    for t in range(1, n):
        h[t] = rho * h[t - 1] + sd_ar * rng.normal()
    return sigma * np.exp(h / 2.0) * rng.normal(size=n)


def build(bt, cfg: dict, y: np.ndarray, dtype, device):
    """The port's model: ``svm`` of the "sigma" type."""
    p = {q["name"]: q for q in cfg["priors"]}
    return bt.svm(y, rho=bt.uniform_prior(p["rho"]["init"], p["rho"]["min"],
                                          p["rho"]["max"]),
                  sd_ar=bt.halfnormal_prior(p["sd_ar"]["init"],
                                            p["sd_ar"]["sd"]),
                  sigma=bt.halfnormal_prior(p["sigma"]["init"],
                                            p["sigma"]["sd"]),
                  dtype=dtype, device=device)


def system(cfg: dict, y: np.ndarray, theta: torch.Tensor) -> System:
    """The plain system at ``theta (B, 3)`` = (rho, sd_ar, sigma): an AR(1)
    log-volatility from its stationary distribution, the signal the state
    itself."""
    kw = dict(dtype=theta.dtype, device=theta.device)
    B = theta.shape[0]
    yt = torch.as_tensor(y, **kw)
    rho, sd, sigma = theta[:, 0], theta[:, 1], theta[:, 2]
    mode0 = torch.log(torch.clamp(yt * yt, min=1e-4))
    return System(
        y=yt, u=torch.ones_like(yt), Z=torch.ones(1, **kw),
        T=rho.reshape(B, 1, 1), RR=(sd * sd).reshape(B, 1, 1),
        a1=torch.zeros(B, 1, **kw),
        P1=(sd * sd / (1.0 - rho * rho)).reshape(B, 1, 1),
        phi=sigma, family=cfg["family"], mode0=mode0)
