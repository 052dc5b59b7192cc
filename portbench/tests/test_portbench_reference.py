"""The plain reference agrees with the port's plain path on the CPU at a
tiny size: the prior, the Laplace approximation (mode and approximate
log-likelihood) in float64, and the psi-APF's estimate within Monte-Carlo
error, at both configurations' models."""
import json

import numpy as np
import pytest
import torch

import bssm_tpu_torch as bt
from bssm_tpu_torch.inference import approx as approx_mod
from bssm_tpu_torch.inference import particle as pf_mod
from bssm_tpu_torch.inference.mcmc import _psi_al
from portbench import harness
from portbench.reference import ssm

CONFIGS = ["poisson_llt", "svm_exchange"]


def _setup(name, n=40, rows=4):
    cfg = json.loads((harness.PB / "configs" / f"{name}.json").read_text())
    cfg["n"] = n
    mod = harness._module(harness.PB / "configs" / f"{name}.py",
                          f"test_cfg_{name}")
    y = mod.series(cfg)
    model = mod.build(bt, cfg, y, torch.float64, "cpu")
    g = torch.Generator().manual_seed(3)
    th0 = torch.as_tensor(model.theta_init, dtype=torch.float64)
    scale = torch.tensor([0.2, 0.2] if name == "poisson_llt"
                         else [0.003, 0.02, 0.05], dtype=torch.float64)
    th = th0 + scale * torch.randn(rows, th0.numel(), generator=g,
                                   dtype=torch.float64)
    return cfg, mod, y, model, th


@pytest.mark.parametrize("name", CONFIGS)
def test_prior_and_laplace_equal_the_port(name):
    cfg, mod, y, model, th = _setup(name)
    assert torch.allclose(ssm.log_prior(cfg["priors"], th),
                          model.log_prior(th), rtol=0, atol=1e-12)
    al = approx_mod.approx_loglik(model.build(th), conv_tol=1e-14)
    lap = ssm.laplace(mod.system(cfg, y, th))
    assert torch.allclose(lap.mode, al.approx.mode, rtol=0, atol=1e-8)
    assert torch.allclose(lap.loglik, al.loglik, rtol=0, atol=1e-7)


@pytest.mark.parametrize("name,N,kk", [("poisson_llt", 10, 1),
                                        ("svm_exchange", 64, 4)])
def test_psi_estimates_agree(name, N, kk):
    """The port's psi log-weight at N particles (its plain path, many
    replications of one theta) and the reference's with many particles
    estimate one likelihood ratio: their means in probability space agree
    within 4 standard errors, and the reference at the port's N has the
    port's spread within 10%."""
    cfg, mod, y, model, th = _setup(name, rows=1)
    R = 4000
    spec = model.build(th.expand(R, -1))
    al = approx_mod.approx_loglik(spec, conv_tol=1e-14)
    g = torch.Generator().manual_seed(11)
    lw = pf_mod.psi_logw(spec, _psi_al(spec, al.approx), N, g,
                         resample_every=kk).numpy()
    sys_r = mod.system(cfg, y, th.expand(R, -1))
    lap = ssm.laplace(sys_r)
    big = ssm.psi_apf(mod.system(cfg, y, th), ssm.Laplace(
        *(x[:1] for x in lap[:6]), ssm.Filtered(*(x[:1] for x in
                                                 lap.filtered))),
        100000, g).item()
    w = np.exp(lw - big)
    assert abs(w.mean() - 1.0) < 4 * w.std() / np.sqrt(R)
    mine = ssm.psi_apf(sys_r, lap, N, g, kk).numpy()
    assert abs(mine.std() / lw.std() - 1.0) < 0.1


def test_control_dtype_runs_and_departs():
    """The bfloat16 control gives finite numbers, far from the float64
    reference's."""
    cfg, mod, y, model, th = _setup("poisson_llt")
    s64 = mod.system(cfg, y, th)
    lap = ssm.laplace(s64)
    lo = ssm.laplace(s64.to(torch.bfloat16), conv_tol=0.0, max_iter=20)
    gap = (lo.loglik.double() - lap.loglik).abs().max().item()
    assert np.isfinite(gap) and gap > 0.05
    lw = ssm.psi_apf(s64.to(torch.bfloat16), lo, 10,
                     torch.Generator().manual_seed(1))
    assert torch.isfinite(lw).all()
