"""bssm_tpu_torch: Bayesian inference for state-space models in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``bssm_tpu`` that lives beside it, module for
module (``core/``, ``ops/``, ``models/``, ``inference/``, ``diagnostics/``,
``parallel/``).
It imports torch and numpy and nothing of JAX or of ``bssm_tpu``.

What runs today:

- on the non-Gaussian ``bsm_ng``, ``ar1_ng``, ``svm`` and ``ssm_ung``:
  IS-MCMC (``mcmc_type`` "is1", "is2", "is3") with ``output_type``
  "theta", "summary" or "full", approximate MCMC ("approx", theta or full
  output), pseudo-marginal (``"pm"``) and delayed-acceptance (``"da"``)
  MCMC with theta or full output, with the psi-auxiliary particle filter,
  the bootstrap filter (any number of particles: kernels up to 512, plain
  scans above) or SPDK importance sampling, on the local or the global
  (``local_approx=False``) Gaussian approximation; ``post_correct`` and
  ``suggest_N``; and on one model ``gaussian_approx``, ``logLik``
  (approximate, particle or SPDK estimate), ``importance_sample``,
  ``kfilter``, ``bootstrap_filter``, ``particle_smoother`` and the
  smoothers through the Gaussian approximation;
- on the multivariate ``ssm_mlg`` (linear-Gaussian, p series, partly
  missing rows allowed) and ``ssm_mng`` (one family per series, Gaussian
  included): the same ``run_mcmc`` flavours as their univariate
  counterparts (mlg "gaussian"; mng approx, is1/is2/is3, pm and da with
  psi, bsf or SPDK, local or global approximation, theta / summary / full
  output as above) and the single-model API; batched tensor code with no
  kernel, as in the JAX package;
- on the nonlinear ``ssm_nlg`` and the ``example_models`` (user model
  functions batched over rows, ``models/nlg.py``): ``run_mcmc`` with
  ``mcmc_type`` "ekf" (theta, summary or full output), approx, is1/is2/is3,
  pm and da with the bootstrap filter (their default) or psi; and on one
  model ``ekf`` (iterated with ``iekf_iter``), ``ukf``, ``ekf_smoother``,
  ``ekf_fast_smoother``, ``ekpf_filter``, ``bootstrap_filter``,
  ``particle_smoother`` (psi, bsf, ekf), ``logLik`` and
  ``gaussian_approx``; batched tensor code with no kernel, as in the JAX
  package;
- on the SDE models ``ssm_sde``, ``sde_gbm`` and ``sde_poisson_ou`` (user
  functions batched over rows, ``models/sde.py``): ``run_mcmc`` with
  approx, is1/is2/is3, pm and da, always the bootstrap filter, the
  coarse level coupled to the fine one by per-row seeds
  (``inference/sde.py``), and on one model ``logLik`` and
  ``bootstrap_filter``; batched tensor code with no kernel;
- ``as_bssm``: the port model of a KFAS ``SSModel`` (an ``.rds`` path or
  the dict ``load_rds`` parses) or of raw system matrices;
- on a run with state output and a model of the future or the past:
  ``predict`` and ``fitted`` (``predict`` only for a nonlinear model);
- on the linear-Gaussian ``bsm_lg``, ``ar1_lg`` and ``ssm_ulg``: marginal
  MCMC (``mcmc_type="gaussian"``) with ``output_type`` "theta", "summary"
  or "full", and ``logLik``, ``fast_smoother``, ``smoother``,
  ``sim_smoother``, ``bootstrap_filter`` and ``particle_smoother`` (the
  bootstrap filter);
- on the output of a run: ``summary``, ``check_diagnostics``, ``iact``,
  ``asymptotic_var``, ``estimate_ess``, ``rhat``, ``ess_bulk``,
  ``ess_tail``, ``rhat_rank``, and ``McmcOutput.save`` / ``load`` (the JAX
  package's ``.npz`` format), ``last_theta`` (resume a run through
  ``run_mcmc``'s ``theta_init`` and ``S``), ``as_draws``,
  ``to_dataframe`` (needs pandas), ``plot`` (needs matplotlib) and
  ``str()``.

The user functions of ``ssm_ulg`` / ``ssm_ung`` / ``ssm_mlg`` /
``ssm_mng`` are torch functions batched over chains (``models/ssm.py``),
those of ``ssm_nlg`` torch functions batched over rows of (time, state,
theta) (``models/nlg.py``), those of ``ssm_sde`` over rows of (state,
theta) (``models/sde.py``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.  ``run_mcmc`` and ``post_correct`` take ``mesh=``
(``make_mesh``; ``parallel.distributed`` starts ``torch.distributed``):
one process a GPU, rows split over the ranks, each row drawn as without a
mesh, the whole output on every rank.
"""

__version__ = "0.1.0"

import torch as _torch

# Kalman covariance recursions lose their meaning under reduced-precision
# products (NaN log-likelihoods, Laplace iterations that never converge).
# The system matrices are tiny, so full-float32 products cost nothing: TF32
# is switched off for matrix products and for cuDNN, process wide.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .core.spec import (LGSpec, NGSpec, MVLGSpec, MVNGSpec,     # noqa: E402
                        SVM, POISSON, BINOMIAL, NEGBIN, GAMMA, GAUSSIAN)
from .core.priors import (uniform_prior, halfnormal_prior,       # noqa: E402
                          normal_prior, tnormal_prior, gamma_prior,
                          PriorStack)
from .models.bsm import bsm_lg, bsm_ng                           # noqa: E402
from .models.ar1 import ar1_lg, ar1_ng                           # noqa: E402
from .models.svm import svm                                      # noqa: E402
from .models.ssm import (ssm_ulg, ssm_ung, ssm_mlg,              # noqa: E402
                         ssm_mng, as_bssm)
from .models.nlg import ssm_nlg, NLGSpec                        # noqa: E402
from .models.sde import (ssm_sde, sde_gbm, sde_poisson_ou,      # noqa: E402
                         SDESpec)
from .models import examples as example_models                  # noqa: E402
from .inference.mcmc import (run_mcmc, McmcOutput,               # noqa: E402
                             is_correction_generator)
from .inference.approx import (approximate, approx_loglik,       # noqa: E402
                               gaussian_approx)
from .inference.smoothers import (fast_smoother, smoother,       # noqa: E402
                                  sim_smoother)
from .inference.loglik import logLik                             # noqa: E402
from .inference.importance import (importance_sample,            # noqa: E402
                                   ImportanceSample)
from .inference.predict import predict, fitted                   # noqa: E402
from .inference.filters import (kfilter, bootstrap_filter,       # noqa: E402
                                particle_smoother, ekf, ukf,
                                ekf_smoother, ekf_fast_smoother,
                                ekpf_filter)
from .inference.postcorrect import post_correct, suggest_N       # noqa: E402
from .parallel.mesh import make_mesh                             # noqa: E402
from .inference.particle import (psi_logw, bsf_logw,             # noqa: E402
                                 psi_logw_scan, bsf_logw_scan,
                                 psi_filter, bsf_filter, bsf_filter_lg,
                                 spdk_sample, spdk_weights, PFResult)
from .inference.sde import bsf_filter_sde, SDEPFResult          # noqa: E402
from .inference.approx_mv import (approximate_mv,               # noqa: E402
                                  approx_loglik_mv, psi_filter_mv,
                                  bsf_filter_mv, spdk_sample_mv)
from .ops.dmvnorm import dmvnorm                                 # noqa: E402
from .ops.resample import ancestor_trace                         # noqa: E402
from .diagnostics.summary import (weighted_mean, weighted_var,   # noqa: E402
                                  ess_is, iact, asymptotic_var,
                                  estimate_ess, rhat, ess_bulk, ess_tail,
                                  rhat_rank, summary, check_diagnostics)
from .utils.datasets import airquality                           # noqa: E402
from .utils.rdata import load_rds, load_rda                      # noqa: E402
