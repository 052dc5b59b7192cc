"""The ``poisson_llt`` configuration: its series, the port's model built
from ``poisson_llt.json`` through the public constructor, and the plain
system that the reference evaluates.  Imports nothing of the program: the
port's package is handed in."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.ssm import System


def series(cfg: dict) -> np.ndarray:
    """The count series of ``cfg["series"]``'s recipe (bssm's
    ``poisson_series`` recipe), n = ``cfg["n"]``."""
    n = cfg["n"]
    rng = np.random.default_rng(cfg["series"]["numpy_seed"])
    slope = np.cumsum(np.r_[0.0, rng.normal(0, 0.01, n - 1)])
    level = np.cumsum(slope + np.r_[0.0, rng.normal(0, 0.1, n - 1)])
    return rng.poisson(np.exp(level)).astype(float)


def build(bt, cfg: dict, y: np.ndarray, dtype, device):
    """The port's model: ``bsm_ng`` with the configuration's priors."""
    pr = {p["name"]: bt.uniform_prior(p["init"], p["min"], p["max"])
          for p in cfg["priors"]}
    return bt.bsm_ng(y, sd_level=pr["sd_level"], sd_slope=pr["sd_slope"],
                     distribution=cfg["family"], a1=np.array(cfg["a1"]),
                     P1=np.array(cfg["P1"]), dtype=dtype, device=device)


def system(cfg: dict, y: np.ndarray, theta: torch.Tensor) -> System:
    """The plain system at sampled-space ``theta (B, 2)`` (log sds)."""
    kw = dict(dtype=theta.dtype, device=theta.device)
    B, m = theta.shape[0], cfg["m"]
    yt = torch.as_tensor(y, **kw)
    sd = torch.exp(theta)
    RR = torch.diag_embed(torch.square(sd))
    mode0 = torch.log(torch.clamp(yt / cfg["u"], min=0.1))
    return System(
        y=yt, u=torch.full_like(yt, cfg["u"]),
        Z=torch.as_tensor(cfg["Z"], **kw),
        T=torch.as_tensor(cfg["T"], **kw).expand(B, m, m), RR=RR,
        a1=torch.as_tensor(cfg["a1"], **kw).expand(B, m),
        P1=torch.as_tensor(cfg["P1"], **kw).expand(B, m, m),
        phi=torch.ones(B, **kw), family=cfg["family"], mode0=mode0)
