"""Posterior predictive simulation and fitted values.

Counterpart of ``bssm_tpu/inference/predict.py``; several series
(``ssm_mlg``, ``ssm_mng``) give signals, means and responses ``(..., n,
p)``, the responses drawn series by series, and so do the nonlinear models
(``_predict_nlg``: their state recursion through T_fn and R_fn, their means
Z_fn, their responses Z_fn + H_fn eps).  ``predict`` picks ``nsim`` stored
draws with the IS weights as probabilities (``torch.multinomial``), builds
the future model at all of them at once (``model.build((nsim, d))``) and
runs the state recursion forward from each draw's final state, one batched
step per time point (``_sim_states``); ``fitted`` replays the stored state
draws through the observation equation.  Every draw comes from one
``torch.Generator`` seeded with ``seed`` on the model's device, in this
order: the pick, the state noise, the observation noise; the JAX package's
threefry streams are not reproduced.  Plain tensor code: the JAX package has
no TPU kernel here either.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.priors import LOG
from ..core.spec import (BINOMIAL, GAMMA, GAUSSIAN, LGSpec, MVLGSpec,
                         MVNGSpec, NEGBIN, POISSON, SVM, at_t, is_mv,
                         with_batch)
from ..models.base import Model
from ..models.nlg import NLGSpec
from .approx_mv import signal_mv
from .nlg import _ev, _times


def _to_sampled(model: Model, theta_nat: torch.Tensor) -> torch.Tensor:
    """Natural-space theta back to the sampled space (log of the entries
    ``model.transforms`` marks as logged)."""
    is_log = torch.as_tensor(np.asarray(model.transforms) == LOG,
                             device=theta_nat.device)
    return torch.where(is_log, torch.log(torch.clamp(theta_nat, min=1e-300)),
                       theta_nat)


def _sim_states(spec, a1: torch.Tensor, generator=None,
                eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """States simulated forward from ``a1 (B, m)`` over the spec's n time
    points, ``(B, n, m)``: alpha_1 = a1, alpha_{t+1} = C_t + T_t alpha_t +
    R_t eta_t.  ``eta (B, n, k)`` is drawn from ``generator`` unless given
    (its last step is not used, as in the JAX package)."""
    n, k = spec.n, spec.k
    if eta is None:
        eta = torch.randn((a1.shape[0], n, k), dtype=a1.dtype,
                          device=a1.device, generator=generator)
    T, C, R = with_batch(spec.T, 3), with_batch(spec.C, 2), \
        with_batch(spec.R, 3)
    a = a1
    out = [a]
    for t in range(n - 1):
        a = at_t(C, t) + (at_t(T, t) @ a.unsqueeze(-1)).squeeze(-1) \
            + (at_t(R, t) @ eta[:, t].unsqueeze(-1)).squeeze(-1)
        out.append(a)
    return torch.stack(out, dim=1)


def _signal(spec, alpha: torch.Tensor) -> torch.Tensor:
    """The signal ``(B, n)`` (``(B, n, p)`` for several series) of states
    ``(B, >= n, m)``: D + Z alpha, the first state for the SV family."""
    n = spec.n
    if is_mv(spec):
        return signal_mv(spec, alpha[:, :n])
    if getattr(spec, "distribution", None) == SVM:
        return alpha[:, :n, 0]
    Z = with_batch(spec.Z, 2)
    D = with_batch(spec.D, 1).to(alpha.dtype)
    return D + (Z * alpha[:, :n]).sum(-1)


def _family_mean(dist: int, signal: torch.Tensor) -> torch.Tensor:
    if dist == SVM:
        return torch.zeros_like(signal)
    if dist == GAUSSIAN:
        return signal
    if dist == BINOMIAL:
        return torch.sigmoid(signal)
    return torch.exp(signal)


def _obs_mean(spec, signal: torch.Tensor) -> torch.Tensor:
    if isinstance(spec, (LGSpec, MVLGSpec)):
        return signal
    if isinstance(spec, MVNGSpec):
        return torch.stack([_family_mean(d, signal[..., j])
                            for j, d in enumerate(spec.distributions)],
                           dim=-1)
    return _family_mean(spec.distribution, signal)


def _col(x: torch.Tensor) -> torch.Tensor:
    return x.unsqueeze(-1) if x.dim() == 1 else x


def _family_sample(dist: int, generator, signal, u, phi) -> torch.Tensor:
    """Observation draws ``(B, n)`` of the family at ``signal``, exposure or
    trials ``u`` and ``phi`` (``(B, 1)`` or scalar)."""
    mean = _family_mean(dist, signal)
    shape = signal.shape
    if dist == GAUSSIAN:
        return signal + phi * torch.randn(shape, dtype=signal.dtype,
                                          device=signal.device,
                                          generator=generator)
    if dist == POISSON:
        return torch.poisson(u * mean, generator=generator)
    if dist == BINOMIAL:
        return torch.binomial(torch.broadcast_to(u, shape).contiguous(),
                              mean, generator=generator)
    gam = torch._standard_gamma(torch.broadcast_to(phi, shape).contiguous(),
                                generator=generator)
    if dist == NEGBIN:
        prob = phi / (phi + u * mean)
        return torch.poisson(gam * (1.0 - prob) / prob, generator=generator)
    if dist == GAMMA:
        return gam * u * mean / phi
    raise ValueError(f"unknown distribution {dist}")


def _obs_sample(spec, signal: torch.Tensor, alpha: torch.Tensor,
                generator=None) -> torch.Tensor:
    """Observations ``(B, n)`` given the signal (and, for the SV family,
    the states)."""
    if isinstance(spec, MVLGSpec):
        # correlated noise through the lower factor H
        H = with_batch(spec.H, 3)
        eps = torch.randn(signal.shape, dtype=signal.dtype,
                          device=signal.device, generator=generator)
        return signal + (H @ eps.unsqueeze(-1)).squeeze(-1)
    if isinstance(spec, MVNGSpec):
        u, phi = with_batch(spec.u, 2), with_batch(spec.phi, 1)
        return torch.stack([
            _family_sample(d, generator, signal[..., j], u[..., j],
                           _col(phi[:, j]))
            for j, d in enumerate(spec.distributions)], dim=-1)
    n = signal.shape[-1]
    if isinstance(spec, LGSpec):
        H = with_batch(spec.H, 1)
        return signal + H * torch.randn(signal.shape, dtype=signal.dtype,
                                        device=signal.device,
                                        generator=generator)
    phi = _col(spec.phi)
    if spec.distribution == SVM:
        return phi * torch.exp(0.5 * alpha[:, :n, 0]) * torch.randn(
            signal.shape, dtype=signal.dtype, device=signal.device,
            generator=generator)
    return _family_sample(spec.distribution, generator, signal,
                          with_batch(spec.u, 1), phi)


def _sim_states_nlg(spec: NLGSpec, a1: torch.Tensor, generator=None,
                    eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A nonlinear model's states simulated forward from ``a1 (B, m)``,
    ``(B, n, m)``: alpha_1 = a1, alpha_{t+1} = T_fn(t, alpha_t) + R_fn(t,
    alpha_t) eta_t.  ``eta (B, n, k)`` is drawn from ``generator`` unless
    given; its last step is not used.  The JAX ``_sim_states_nlg`` emits
    a1 once too (its scan returns the state before each step)."""
    n, k = spec.n, spec.k
    if eta is None:
        eta = torch.randn((a1.shape[0], n, k), dtype=a1.dtype,
                          device=a1.device, generator=generator)
    a = a1
    out = [a]
    for t in range(n - 1):
        a = _ev(spec.T_fn, spec, t, a) \
            + (_ev(spec.R_fn, spec, t, a) @ eta[:, t, :, None])[..., 0]
        out.append(a)
    return torch.stack(out, dim=1)


def _predict_nlg(spec: NLGSpec, a1: torch.Tensor, type: str, generator):
    """``predict`` of a nonlinear model at the picked draws: states ``(B,
    n, m)``, means Z_fn ``(B, n, p)`` or responses Z_fn + H_fn eps."""
    states = _sim_states_nlg(spec, a1, generator)
    if type == "state":
        return states
    tr = _times(spec, states.shape[0], spec.n)
    mean = _ev(spec.Z_fn, spec, tr, states)
    if type == "mean":
        return mean
    eps = torch.randn(mean.shape, dtype=mean.dtype, device=mean.device,
                      generator=generator)
    return mean + (_ev(spec.H_fn, spec, tr, states) @ eps[..., None])[..., 0]


def _flat(output):
    th = output.flat_theta()
    alpha = output.alpha.reshape((-1,) + output.alpha.shape[2:])
    return th, alpha


def predict(output, model: Model, type: str = "response", nsim: int = 1000,
            seed: int = 1) -> np.ndarray:
    """Posterior predictive draws over the timeline of ``model``, which
    describes the future: its y length sets the horizon (the values are
    ignored) and the stored final states (``alpha[:, :, -1]``, the one-step
    prediction beyond the data) start the state recursion.  ``type``
    "state" returns ``(nsim, n, m)``, "mean" and "response" ``(nsim, n)``
    (``(nsim, n, p)`` for several series and for a nonlinear model).
    Needs a run with ``output_type="full"``."""
    if model.kind == "sde":
        raise ValueError("predict does not take an SDE model (the JAX "
                         "package's fails on one)")
    if output.alpha is None:
        raise ValueError("predict needs output_type='full'")
    if type not in ("state", "mean", "response"):
        raise ValueError(f"type={type!r}: 'state', 'mean' or 'response'")
    dev, dt = model.device, model.dtype
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    th, alpha = _flat(output)
    w = torch.as_tensor(output.flat_weights(), dtype=torch.float64,
                        device=dev)
    idx = torch.multinomial(w / w.sum(), int(nsim), replacement=True,
                            generator=gen)
    thetas = torch.as_tensor(th, dtype=dt, device=dev)[idx]
    a1 = torch.as_tensor(alpha[:, -1], dtype=dt, device=dev)[idx]
    spec = model.build(_to_sampled(model, thetas))
    if model.kind == "nlg":
        return _predict_nlg(spec, a1, type, gen).cpu().numpy()
    states = _sim_states(spec, a1, gen)
    if type == "state":
        return states.cpu().numpy()
    sig = _signal(spec, states)
    if type == "mean":
        return _obs_mean(spec, sig).cpu().numpy()
    return _obs_sample(spec, sig, states, gen).cpu().numpy()


FITTED_ROWS = 65536      # draws a chunk of ``fitted``; bounds memory only


def fitted(output, model: Model, type: str = "mean",
           seed: int = 1) -> np.ndarray:
    """Fitted values of every stored draw, ``(draws, n)`` (``(draws, n,
    p)`` for several series): the observation
    mean (``type="mean"``) or one observation draw (``"response"``) at the
    stored states, the model built at the stored theta; in chunks of
    ``FITTED_ROWS`` draws.  Needs a run with ``output_type="full"``."""
    if model.kind == "sde":
        raise ValueError("fitted does not take an SDE model (the JAX "
                         "package's fails on one)")
    if output.alpha is None:
        raise ValueError("fitted needs output_type='full'")
    if model.kind == "nlg":
        raise ValueError("fitted is not defined for a nonlinear model here "
                         "(the JAX package's fails on one, as its NLGSpec "
                         "has no Z); use predict on a model of the past")
    if type not in ("mean", "response"):
        raise ValueError(f"type={type!r}: 'mean' or 'response'")
    dev, dt = model.device, model.dtype
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    th, alpha = _flat(output)
    parts = []
    for lo in range(0, th.shape[0], FITTED_ROWS):
        sl = slice(lo, lo + FITTED_ROWS)
        spec = model.build(_to_sampled(
            model, torch.as_tensor(th[sl], dtype=dt, device=dev)))
        a = torch.as_tensor(alpha[sl], dtype=dt, device=dev)
        sig = _signal(spec, a)
        res = _obs_mean(spec, sig) if type == "mean" \
            else _obs_sample(spec, sig, a, gen)
        parts.append(res.cpu().numpy())
    return np.concatenate(parts)
