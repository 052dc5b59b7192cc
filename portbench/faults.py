"""Faults planted in the port underneath a run, to show that the
comparison catches them (``portbench/tests/test_portbench_faults.py`` on
the CPU, ``python3 -m portbench.readings --fault-seeds`` on the card).
Each is a context manager that patches one function of the port for as
long as it is entered:

- ``frozen``: the chain step returns its state unchanged;
- ``half``: the correction computes half of each chunk's rows and gives
  the others the mean of those;
- ``is_answer``: each correction log-weight altered by 0.2 where the
  filter produces it;
- ``laplace_answer``: the approximate log-likelihood altered by 1.5 nats
  where the Laplace approximation produces it (above the float32
  round-off of the longest series, which reads up to about 0.6).

The cells run on one chip, so no exchange between chips can be left out.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(mod, name, wrap):
    orig = getattr(mod, name)
    setattr(mod, name, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def frozen():
    import torch
    from bssm_tpu_torch.inference import mcmc

    def wrap(orig):
        def step(logdens, log_prior, state, *a, **k):
            _, accept = orig(logdens, log_prior, state, *a, **k)
            return state, torch.zeros_like(accept)
        return step
    return _patched(mcmc, "_ram_step", wrap)


def half():
    from bssm_tpu_torch.inference import particle

    def wrap(orig):
        def psi_logw(*a, **k):
            lw = orig(*a, **k)
            h = lw.shape[0] // 2
            out = lw.clone()
            out[h:] = lw[:max(h, 1)].mean()
            return out
        return psi_logw
    return _patched(particle, "psi_logw", wrap)


def is_answer():
    from bssm_tpu_torch.inference import particle
    return _patched(particle, "psi_logw",
                    lambda orig: lambda *a, **k: orig(*a, **k) + 0.2)


def laplace_answer():
    from bssm_tpu_torch.inference import approx

    def wrap(orig):
        def approx_loglik(*a, **k):
            r = orig(*a, **k)
            return r._replace(loglik=r.loglik + 1.5)
        return approx_loglik
    return _patched(approx, "approx_loglik", wrap)


FAULTS = {"frozen": frozen, "half": half, "is_answer": is_answer,
          "laplace_answer": laplace_answer}
