#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package ``bssm_tpu_torch`` on one NVIDIA GPU.

    python3 chip_smoke.py            # full run, needs one CUDA device
    python3 chip_smoke.py --iter 200 # shorter main path
    python3 chip_smoke.py --big-only # the large-ensemble kernel alone
    python3 chip_smoke.py --ab DIR   # A/B of K2, K3 against the package in DIR
    python3 chip_smoke.py --ab DIR --ab-set big   # the same for K4 / K5
    python3 chip_smoke.py --geometry-sweep   # K4 / K5 launch geometries
    python3 chip_smoke.py --grid-depth 4000  # the replication grid, deep
    python3 chip_smoke.py --mv-only  # the multivariate models alone
    python3 chip_smoke.py --nlg-only # the nonlinear models alone
    python3 chip_smoke.py --sde-only # the SDE models and as_bssm alone
    python3 chip_smoke.py --tp-only  # the time-parallel option alone
    python3 chip_smoke.py --mesh-only  # run_mcmc(mesh=...) alone
    python3 chip_smoke.py --api-only   # approx_full and the api phase alone

What it does, in order:

1. builds the CUDA kernels from ``bssm_tpu_torch/csrc`` (nvcc, sm_90a);
2. holds each kernel (``laplace_solve``, ``rts_factors``, ``psi_logw``)
   against its plain PyTorch version on the card, at the main path's shapes
   (n = 153, m = 2, Poisson, B = 4096 / 16384 rows, N = 10 particles) in
   float32 and float64, and at small shapes over the other state dimensions,
   observation families and particle counts; times kernel and plain version
   with CUDA events at B = 1024 / 4096 / 16384, and the bare kernel's device
   time (events around launches with pre-built arguments); a
   ``laplace_solve`` call must be one device kernel (CUDA-graph capture)
   and one launch of its own; ``laplace_solve`` again at footprints beyond
   shared memory (m = 4, n = 1200 float64 and n = 2200 float32), where it
   stages in device memory, and the staging sweep: both stagings at n = 153,
   m = 1..4, both dtypes, B = 1024..32768, timed bare and held against each
   other, and the same for ``rts_factors``' two stagings at B = 1024,
   4096, 16384 (``--staging-sweep`` runs only those); ``rts_factors`` on both
   sides of each limit of its staging rule (``check_rts_staging``: the wave
   limit at the main path's model in float64, the shared-memory footprint
   at m = 2 float32 and m = 4 float64, m = 1 and 3 at small shapes), each
   against the plain version and the other staging, forced, against the
   rule's to the bit; ``psi_logw`` at N in {1, 7, 8, 10, 16, 17, 32} (every
   width of a row's segment of lanes) at B = 1024 in float32 and float64;
3. does the same for ``laplace_step`` (one Laplace pass) at B = 1 / 4096 /
   16384 and over the same families and state dimensions, and holds the
   single-model solve (the host loop over it) against ``laplace_solve`` at
   B = 4096 in float64;
4. does the same for the large-ensemble kernel in its two modes
   (``psi_big_logw``, ``bsf_big_logw``): stream mode against the plain
   versions at B = 2048, N in {256, 200}, resampling period in {1, 8}, and
   at B = 256 over families, state dimensions, N in {2, 32, 33, 40, 512};
   Philox
   mode against stream mode and against the plain versions on tensors that
   ``philox_fill`` wrote, the filled tensors against their plain version
   and their moments, at the shapes the paths give the kernel; in float32
   the kernel fed the ancestors the plain version's own search chose
   (``check_anc``) at the shapes of ``pm_bsf_N200``, ``da_psi_N64`` and
   ``psi_N256``'s correction, and at N = 300 and 512 (two warps a row),
   every row at the tight tolerance; two warps a row at N = 300 in float64
   against the plain versions; and times both modes at B = 16384 against
   the plain versions on the same tensors (``--big-only`` runs only this
   step; ``--geometry-sweep`` only its times under launch geometries the
   rule does not pick, ``geometry_sweep``);
5. holds the two linear-Gaussian kernels (``log_likelihood``,
   ``fast_smoother_ll``) against their plain versions: the airquality
   ``bsm_lg`` model (n = 153, m = 2, Wind and Temp as regressors, so D varies
   over time and rows; 37 missing y) at B = 4096 / 16384, with four rows
   whose sds make the model degenerate, and a sweep over m = 1..4 with
   missing y and time-varying D at n = 40, plus ``ar1_lg`` (initial state
   and C vary over rows), float32 and float64; a per-row D over several
   chunks of the log-likelihood kernel's shared-memory tile (n = 300, 600,
   with degenerate rows); times both kernels and their plain versions at
   B = 1024 / 4096 / 16384 / 65536, with the bare kernel's device time and
   one device kernel a ``log_likelihood`` call; then ``laplace_solve`` and
   ``log_likelihood`` on three layouts of the same leaves (as built, expand
   views of stride 0, per-row copies with non-contiguous cores) against the
   plain versions, timed at B = 4096;
6. holds the kernels against their plain versions at shapes the steps
   above never gave them (``sv_checks``): K1, K2 and K3 on the SV family
   at n = 945, m = 1, float32 at 8192 rows (timed) and 2048 (K1), float64
   at 256, both ``svm`` types; K4 (N = 64, period 4) there, float32 fed the
   plain version's ancestors (every row), float64 against the plain
   version, and timed at 8192 rows; K1-K3 with T, R, a1, P1 and C per row
   (``ar1_ng`` negative binomial, 1024 rows, both dtypes);
7. drives 40 paths and the multivariate, nonlinear, SDE and KFAS APIs
   through the
   public entry points and gates each (finite values, acceptance rate,
   ESS_IS fraction where there are weights, the path's kernels launched
   by that very run, and no plain route taken on the card,
   ``cuda_kalman.PLAIN_ROUTES``):
   ``psi_N10`` / ``psi_N256`` (resampling period 8) / ``psi_N256_refexact``
   (period 1): IS-MCMC (``mcmc_type="is2"``) on a level + slope ``bsm_ng``
   Poisson model, n = 153, 4096 / 4096 / 1024 chains; ``pm_bsf_N200``:
   pseudo-marginal MCMC with a 200-particle bootstrap filter on a level-only
   model, 1024 chains; ``da_psi_N64``: delayed acceptance, 1024 chains;
   ``gamma_airquality_N10``: the JAX package's gamma bench row (bench.py:
   205-219), is2/psi with 10 particles on a gamma level + slope ``bsm_ng``
   on airquality Ozone with Wind and Temp, 4096 chains, its ESS_IS fraction
   within 4 sqrt(2) jackknife standard errors of the reference's 0.8918
   (``BENCH_r05.json``);
   ``lg_theta`` / ``lg_summary`` / ``lg_full``: linear-Gaussian marginal
   MCMC on the airquality ``bsm_lg`` with ``output_type`` "theta" (4096
   chains), "summary" and "full" (1024 chains, the same seed, so the same
   theta chains); the full draws must average to the summary's means within
   6 sqrt(Vt / draws) at every (t, j); ``is2_full`` / ``is1_summary`` /
   ``approx_full``: the level + slope model's state outputs, 1024 chains,
   one seed (one theta chain): is2 with one filter trajectory per slot, is1
   with the weighted moments (the draws must average to its alphahat
   within 6 sqrt(Vt / ESS)), and approx with one simulation-smoother draw
   per slot, which ``post_correct`` with the run's correction generator
   must turn into is2_full's weights; then the ``api`` phase
   (``api_phase``; ``--api-only`` runs ``approx_full`` and it alone), the
   JAX package's call forms at the main path's width: ``post_correct``
   with its arguments in the JAX package's positional order on
   ``approx_full``'s run, full and theta output, equal to the keyword
   calls to the bit with their launches and no plain route;
   ``spdk_sample`` at 4096 rows (``antithetic=True`` equal to the default
   to the bit, ``antithetic=False`` within 5 jackknife SEs, K7 launched);
   ``systematic_indices`` / ``stratified_indices`` on 16384 x 256 weights
   (counts within 1 / 2 of N w); ``smoother(spec, want_ccov=True)`` equal
   to ``smoother(spec)``; the phase within 30 s; ``ng_api``: the
   non-Gaussian public API on one model (the single-model Laplace solve,
   K8);
   ``seasonal_ng_is2`` / ``seasonal_lg_gaussian``: models outside the
   kernels' contract on a simulated monthly series (n = 144, seed 12),
   is2/psi with 10 particles on a Poisson level + seasonal(12) ``bsm_ng``
   (m = 12, 256 chains) and ``gaussian`` summary output on a level + slope
   + seasonal(12) ``bsm_lg`` (m = 13, 1024 chains): they must take the
   plain versions on the card (plain routes > 0) and launch no kernel;
   and the other univariate models: ``svm_is2_N64`` (``svm`` "sigma" type
   on a simulated series of the exchange data's length, n = 945, is2/psi
   with 64 particles, period 4, 2048 chains, acceptance in [0.10, 0.65]
   and ESS_IS >= 0.9, the JAX package's zoo window and floor),
   ``ar1_ng_negbin_pm_N10`` (pseudo-marginal psi, 10 particles, 1024
   chains, [0.10, 0.55]), ``ssm_ung_is2`` (the main path's model through a
   batched ``update_fn`` and ``prior_fn``, 4096 chains) and
   ``ssm_ulg_gaussian`` (airquality's local linear trend, H and R from
   ``update_fn``, 4096 chains), all on the kernels (no plain route);
   and the non-Gaussian MCMC options on the main path's model
   (``option_paths``): ``psi_N10_global`` (``local_approx=False``: K7
   once an iteration, K8 for the solve at ``theta_init``, no K1),
   ``spdk_N10`` (SPDK's phase 2: K7 over the chunk's rows and its 5
   simulated series a row; ``psi_N10``'s acceptance to the last digit),
   ``is2_psi_N1024`` (1024 chains, the plain tier above 512 particles, no
   particle kernel), each with its weighted means within 5 combined SEs of
   ``psi_N10``'s, and ``pm_psi_full_N10`` / ``da_spdk_full_N10`` (1024
   chains, state output: rejected slots repeat, every state mean within 6
   combined SEs of ``is2_full``'s weighted mean; a pm theta-output run of
   the same size times the chain-time ratio); and the multivariate models
   (``mv_section``; ``--mv-only`` runs only them), batched tensor code with
   no kernel (every launch, replay and plain-route count must stay 0):
   ``mlg_gaussian``, bssm's README example as ``ssm_mlg`` (airquality
   Ozone and Temp, a local level each, H and R from ``update_fn``; 1024
   chains, ``--iter`` iterations, full output; the draws within 6
   sqrt(Vt / draws) of ``smoother_mv``'s moments over the same thetas);
   ``mng_is2_psi_N10`` / ``mng_da_psi_N10``, the JAX package zoo's
   Poisson + Gaussian ``ssm_mng`` (n = 80, 1024 chains, ``--mv-iter``
   iterations; is2's psi weighted means within 5 combined SEs of is2/bsf
   with 200 particles on the same phase-1 chain, ``post_correct``); and
   ``mv_api``, the single-model API on that model, its ``predict`` /
   ``fitted``, and its one-series reduction against ``ssm_ung``; the
   device operations of the blocks a chain iteration repeats are counted
   by stream capture and timed eager and replayed (``mv_ops`` line); and
   the nonlinear models (``nlg_section``; ``--nlg-only`` runs only them),
   batched tensor code with no kernel (every count must stay 0), on the
   JAX package's growth model at its defaults (``simulate_growth()``, n =
   100, m = 2, d = 3): ``nlg_growth_ekf`` (``mcmc_type="ekf"``, 1024 x
   300, full output, its draws within 6 sqrt(Vt / draws) of the extended
   Kalman smoother's moments over the same thetas),
   ``nlg_growth_is2_psi_N10`` (1024 x 40 from the ekf chains' last theta
   and RAM scale; ``post_correct`` of its chain with psi N = 100 and bsf
   N = 200, psi 10's and bsf 200's weighted means within 5 combined SEs
   of psi 100's) and ``nlg_growth_pm_psi_N10`` (1024 x 40 from draws
   is2's start does not share: the ekf chains' draws 142 iterations and
   more before it, importance-resampled to the exact posterior; within 5
   of is2's), the ``nlg_ops`` line (the device operations of the EKF
   log-likelihood, a Gauss-Newton start, pass and final likelihood and a
   psi estimate, eager against replayed, replay bit-equal; the EKF with
   forward-mode Jacobians replayed too), the ``nlg_checks`` phase
   (``nlg_linear_gaussian`` against K6 / K7 on its ``ssm_ulg`` twin, EKPF
   128 against the Kalman likelihood and psi 64 against psi 2048 over
   4096 replications) and ``nlg_api``, the single-model API; and the SDE
   models (``sde_section``; ``--sde-only`` runs only them, with
   ``as_bssm``), batched tensor code with no kernel (every count must stay
   0), 1024 chains: ``sde_gbm_is2_N16`` (the JAX package zoo's row,
   ``sde_gbm`` on its n = 40 series, L_f = 4, L_c = 2, is2/bsf with 16
   particles, 500 iterations; acceptance and ESS_IS printed beside the
   zoo's; weighted means within 4 SEs of the paired difference of its
   ``post_correct`` with 128 particles from the stored seeds),
   ``sde_poisson_ou_da_N16`` and ``sde_poisson_ou_is2_N16``
   (``sde_poisson_ou`` at its defaults on
   an n = 100 series of its own law, 300 iterations each from unrelated
   seeds, their means within 4 combined SEs; da's first- and second-stage
   acceptance), the ``sde_ops`` line (the device operations of the coarse
   and fine filters and of da's pair, eager against replayed, replay
   bit-equal), the ``sde_checks`` phase (Milstein's moments against the
   exact GBM law, the coupling of one seed's coarse and fine filters,
   seeded and stream mode on the card against the CPU in float64),
   ``sde_api`` and ``kfas_api`` (``as_bssm`` of five KFAS layouts against
   hand-built twins, then ``kfas_ulg_gaussian`` (K6) and
   ``kfas_ung_is2_psi_N10`` (K1-K3), 1024 x 100); and the time-parallel
   Kalman option (``tp_section``; ``--tp-only`` runs only it), where
   neither Laplace kernel may launch
   and no plain route may be taken: ``tp_checks`` (the Laplace solve under
   ``parallel_time()`` against K1 at the main path's and
   ``svm_is2_N64``'s shapes, ``kfilter_parallel`` and
   ``fast_smoother_parallel`` in float32 against the float64 sequential
   plain versions), ``tp_grid`` (n in {512, 4096, 16384} x B in {1, 8,
   64}: K6 and K1 against the scans, timed, every float32 value against
   float64), ``psi_N10_tp`` (4096 x 500) and ``svm_is2_N64_tp`` (2048 x
   300) under ``parallel_time()``, gated as ``psi_N10`` / ``svm_is2_N64``
   are and their weighted means within 5 combined SEs of their sequential
   twins' (``_tp_twin``: the same runs, depths and seeds), ``tp_api``
   (the single-model API under the flag against without it, float64) and
   a ``profile_trace`` of one ``logLik`` (a Chrome trace with CUDA
   kernels, in ``chiprun_out/tp_profile``), the phases timed by
   ``PhaseTimer``; and ``run_mcmc(mesh=...)`` over ``torch.distributed``
   (``mesh_section``; ``--mesh-only`` runs only it): run 1, a world of
   one over NCCL (``make_mesh()``), ``psi_N10``'s run at 4096 chains x
   200 iterations with the mesh against two runs of the same seed without
   it (path ``mesh_psi_N10_nccl``); run 2, two ranks on the one card in
   processes of their own (this script with ``--mesh-rank``; gloo, whose
   collectives go through host memory, since NCCL refuses two ranks on
   one device), 2048 chains each on ``psi_N10``'s and ``lg_theta``'s runs
   (200 iterations) and 512 on ``pm_bsf_N200``'s and ``psi_N256``'s at
   period 8 (100), every rank's gathered output against this process's
   run without a mesh; thetas, acceptance flags, posteriors, weights and
   RAM factors bit for bit, the weighted means within the gap of the two
   unsharded runs, the runs' kernels launched in the ranks (K4 and K5 in
   Philox mode, their counters offset by the rank's first row) and no
   plain route;
8. the ``diagnostics`` phase on ``psi_N10``'s output (4096 chains x 500
   draws): ``summary`` and ``check_diagnostics`` timed and finite, the
   summary's means equal to the weighted means computed on the card to
   1e-6, the native library built, ``save`` / ``load`` equal in every
   field, and 100 iterations resumed from ``last_theta`` and ``S`` that
   start inside the posterior's range; then the phases of the options
   (``options_section``): ``replications`` (bssm's grid, 24 cells, one
   ``replication`` line each, every cell held against is2/bsf/local,
   ``replications_phase``), ``bign_checks``
   (the plain tier at N = 1024 against K4 / K5 at 512 by the likelihood
   they estimate; its per-step draws against the injected stream),
   ``global_checks`` (K7 at the global and SPDK shapes against its plain
   version, timed; the CUDA-graph replay of pm / da estimates against the
   eager calls, to the bit) and ``predict_fitted``;
9. prints one JSON object per line: ``card``, ``checks``, ``step_checks``,
   ``big_checks``, ``lg_checks``, ``sv_checks``, the phases' lines,
   ``mv_ops``, ``nlg_ops``, ``sde_ops``, one
   ``path`` line each (``main_path`` for ``psi_N10``), ``diagnostics``,
   ``nlg_checks``, ``sde_checks``, ``tp_checks``, ``mesh``, ``api``,
   ``kernels`` (each kernel's launches by its wrapper, and apart from
   them ``replayed``, the launches CUDA-graph replays repeated), the
   card's name and power limit, and last ``{"ok": true, "device":
   {...}}``.

``--ab DIR`` runs only the one-card A/B of this package against an earlier
one checked out in DIR (``git archive <rev> | tar -x -C DIR``): four
processes, parent, change, change, parent, each building its kernels and
printing the readings of ``--ab-set`` (``k2k3``: wrapper and bare
milliseconds of ``rts_factors`` and ``psi_logw`` at B = 1024, 4096 and
16384, digests of their outputs on fixed inputs, so that the ``ab`` line
says where the two packages agree to the bit, ``psi_N10``'s phase 2 and
``da_psi_N64``'s chain; ``big``: the
large-ensemble kernel at its three path shapes and the four paths it
paces), then one ``ab`` line.

Any failed check ends the run with a non-zero exit code and without the last
line.  Tolerances (|a - b| <= tol (1 + |b|)):
  float64: 1e-9 on every output of every kernel;
  float32: laplace_solve and laplace_step mode (and the step's change)
  1e-4, log-likelihood 1e-3; rts_factors ahat
  1e-4 (1e-3 for m >= 3), Ab 1e-3, Lb Lb' 5e-3; psi_logw 1e-4.  In float32 a
  kernel and its plain version sum in different orders, and a difference of
  one ulp can flip a discrete decision (an eigenvalue clip, a resampled
  ancestor, the pass at which an iteration stops), after which that row
  differs visibly.  So in float32 the tolerance must hold for 99% of the
  entries, every entry must stay inside 100x the tolerance or 0.5, whichever
  is larger, and the share of entries outside the tolerance is printed.
  Large-ensemble kernel, per row: float64 1e-9 (1 + |ref|), every row.
  float32: one ulp in a cumulative weight flips a resampled ancestor, and
  after that the two runs are different, equally valid draws.  A row meets
  about lambda = c x (resampling steps) x N^2 x 2^-23 such near-ties (each of
  N particles has about one of N cumulative weights in its stratum of width
  1/N; c is the typical difference of two summation orders in units of
  2^-23, read on the card as 0.13-0.29 in psi mode and 0.23-0.50 in
  bootstrap mode, and set to 0.3 and 0.5).  With p = exp(-lambda) the share
  of the B rows inside the tight tolerance must be at least
  p - 0.02 - 4 sqrt(p (1 - p) / B): 0.96 at the N = 64, n = 11, B = 128 of
  the JAX package's own kernel test, whose tolerance this is, 0.92 at
  N = 256, B = 2048 with period 8 and 0.64 with period 1 (psi mode).  The
  tight tolerance is 2e-4 + 2e-6 sum|scales| in psi mode (the log-weight is
  a residue of |scales|-sized terms) and 2e-4 (1 + |ref|) in bootstrap mode.
  Every row must stay inside 0.35 (psi: ten times the largest difference a
  flip was seen to make) or 0.5 + 0.05 |ref| (bootstrap, where a flip moves
  the estimate by its Monte-Carlo spread; also about ten times the largest
  seen), and the mean difference over the rows must lie within 5 of its
  standard errors of zero: flips are draws, not a bias.  The share of rows
  outside the tight tolerance ("flipped") is printed.  With the plain
  version's own ancestors injected into the kernel no ancestor can flip, and
  float32 must hold every row inside the tight tolerance.  Philox mode
  against stream mode: 1e-6 (float32) / 1e-12 (float64) scaled, every row.
  Linear-Gaussian kernels, every entry: float64 1e-9 (1 + |ref|); float32
  as the JAX package's kernel tests (tests/test_pallas.py): log-likelihood
  1e-5 + 2e-5 |ref|, smoothed means 3e-4 (1 + the row's largest |ref|).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

F32_TOL = {"mode": 1e-4, "ll": 1e-3, "ahat": 1e-4, "ahat_m3": 1e-3,
           "Ab": 1e-3, "LL": 5e-3, "logw": 1e-4}
F64_TOL = 1e-9
PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores

CHAINS = 4096                    # the main path's width; only depth is cut

# theta posterior means of the JAX package's bsm_lg airquality run at 20000
# iterations (PARITY_r05.json, test_airquality_bsm_lg_parity), printed
# beside the lg paths' for reading, not gated on
LG_PARITY = {"sd_y": 20.923603950767504, "sd_level": 6.30421305925652,
             "sd_slope": 0.33842104627228353, "Wind": -2.5523095236378777,
             "Temp": 1.032753090402032}

FAILURES: list = []


def emit(tag: str, obj: dict) -> None:
    print(json.dumps({tag: obj}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_nodes(fn, warm: bool = True) -> list:
    """The types of the nodes of the CUDA graph that one call of ``fn``
    records under stream capture (0: kernel): the device work a call
    enqueues, counted exactly.  ``warm=False``: ``fn`` has run already,
    so the eager call before the capture is left out."""
    import ctypes
    cudart = ctypes.CDLL("libcudart.so.12")
    if warm:
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
    h = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cudart.cudaGraphGetNodes(h, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    cudart.cudaGraphGetNodes(h, nodes, ctypes.byref(n))
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        cudart.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        types.append(t.value)
    del g
    return types


def one_kernel(fn, counter: str) -> dict:
    """A call of ``fn`` enqueues exactly one device operation, a kernel
    (``graph_nodes`` under stream capture), and over that captured call the
    wrapper's launch count ``counter`` rises by exactly one: so the one
    kernel is the wrapper's own.  Otherwise the check fails."""
    from bssm_tpu_torch.ops import cuda_kalman as ck
    before = dict(ck.LAUNCHES)
    types = graph_nodes(fn)
    rise = {k: v - before[k] for k, v in ck.LAUNCHES.items() if v != before[k]}
    # graph_nodes calls fn twice: once to warm up, once under capture
    res = {"graph_node_types": types, "launch_count_rise": rise,
           "ok": types == [0] and rise == {counter: 2}}
    if not res["ok"]:
        FAILURES.append({"what": f"one device kernel a call ({counter})",
                         **res})
    return res


def bare_ms(fn, entry: str, reps: int = 10) -> float:
    """Device milliseconds of one launch of the kernel behind the C entry
    ``entry`` with the arguments that one call of the wrapper ``fn`` built:
    CUDA events around ``reps`` launches with those pre-built arguments, no
    host work of the wrapper in between (the launches queue faster than the
    kernels run).  Every tensor whose pointer the wrapper took (outputs,
    scratch, and copies it made of its inputs) is held until the launches
    are done, so that none of them reads memory handed back meanwhile."""
    from unittest import mock
    from bssm_tpu_torch.ops import cuda_kalman as ck
    lib = ck._load()
    orig = getattr(lib, entry)
    seen, held = [], []
    data_ptr = torch.Tensor.data_ptr

    def spy(*args):
        seen.append(args)
        return orig(*args)

    def hold(t):
        held.append(t)
        return data_ptr(t)

    setattr(lib, entry, spy)
    try:
        with mock.patch.object(torch.Tensor, "data_ptr", hold):
            fn()
    finally:
        setattr(lib, entry, orig)
    args = seen[-1]
    for _ in range(2):
        orig(*args)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        orig(*args)
    b.record()
    torch.cuda.synchronize()
    del held
    return a.elapsed_time(b) / reps


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, tol: float,
            strict: bool) -> dict:
    """Scaled error |got - ref| / (1 + |ref|) against ``tol``; NaN must sit
    in the same places.  ``strict``: every entry inside ``tol``; otherwise
    99% inside ``tol`` and all inside max(100 tol, 0.5)."""
    got, ref = got.double(), ref.double()
    same_nan = bool((torch.isnan(got) == torch.isnan(ref)).all())
    same_inf = bool((torch.isinf(got) == torch.isinf(ref)).all())
    fin = torch.isfinite(got) & torch.isfinite(ref)
    diff = torch.where(fin, (got - ref).abs(), torch.zeros_like(ref))
    scaled = diff / (1.0 + torch.where(fin, ref.abs(), torch.zeros_like(ref)))
    max_abs = float(diff.max())
    outside = float((scaled > tol).double().mean())
    if strict:
        ok = float(scaled.max()) <= tol
    else:
        ok = outside <= 0.01 and float(scaled.max()) <= max(100 * tol, 0.5)
    ok = ok and same_nan and same_inf
    res = {"what": name, "max_abs_err": max_abs,
           "max_scaled_err": float(scaled.max()), "tol": tol,
           "share_outside_tol": outside, "ok": ok}
    if not ok:
        FAILURES.append(res)
    return res


def outer(L: torch.Tensor) -> torch.Tensor:
    return L @ L.transpose(-1, -2)


# ---------------------------------------------------------------------------
# models and inputs
# ---------------------------------------------------------------------------

def bench_series(n: int = 153):
    """The two series of the JAX package's bench.py (numpy recipe, seed 1,
    drawn in its order): n = 153 Poisson counts around a slowly drifting
    level, and the calmer level-only series of its bootstrap-filter row;
    another ``n`` draws the same recipe at that length."""
    rng = np.random.default_rng(1)
    slope = np.cumsum(rng.normal(0, 0.01, n))
    level = np.cumsum(slope + rng.normal(0, 0.1, n)) + 2.0
    y = rng.poisson(np.exp(0.5 * level / np.abs(level).max() + 1.0))
    yb = rng.poisson(np.exp(np.cumsum(rng.normal(0, 0.03, n)) + 1.0))
    return y.astype(float), yb.astype(float)


def main_path_series(n: int = 153) -> np.ndarray:
    return bench_series(n)[0]


def calm_model(bt, dtype):
    """bench.py's model of the pseudo-marginal row: level only, m = 1."""
    return bt.bsm_ng(bench_series()[1],
                     sd_level=bt.halfnormal_prior(0.05, 0.5),
                     distribution="poisson", dtype=dtype, device="cuda")


def main_path_model(bt, dtype, n: int = 153):
    """The main path's model; another ``n``: on bench.py's series recipe
    at that length."""
    return bt.bsm_ng(main_path_series(n),
                     sd_level=bt.halfnormal_prior(0.1, 1.0),
                     sd_slope=bt.halfnormal_prior(0.01, 0.1),
                     distribution="poisson", dtype=dtype, device="cuda")


def sweep_model(bt, family: str, m: int, dtype, n: int = 40,
                xreg: bool = False, p1=None):
    """A small bsm_ng model with state dimension ``m`` (1: level, 2: level +
    slope, 3: level + seasonal(3), 4: level + slope + seasonal(3)) and two
    missing observations; ``xreg`` adds two regressors, which make the
    intercept D vary over time and over rows; ``p1`` replaces the diffuse
    initial variance 100 on the diagonal of P1."""
    rng = np.random.default_rng(100 + m)
    lam = np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0)
    kw = dict(sd_level=bt.halfnormal_prior(0.1, 1.0), distribution=family,
              dtype=dtype, device="cuda")
    if m in (2, 4):
        kw["sd_slope"] = bt.halfnormal_prior(0.01, 0.1)
    if m in (3, 4):
        kw["sd_seasonal"] = bt.halfnormal_prior(0.05, 1.0)
        kw["period"] = 3
    if family == "svm":
        y = rng.normal(0, 1, n) * np.exp(0.3 * np.sin(np.arange(n) / 5))
    elif family == "binomial":
        kw["u"] = np.full(n, 12.0)
        y = rng.binomial(12, lam / (1 + lam)).astype(float)
    elif family == "gamma":
        kw["phi"] = 4.0
        y = rng.gamma(4.0, lam / 4.0)
    else:
        if family == "negative binomial":
            kw["phi"] = 3.0
        y = rng.poisson(lam).astype(float)
    y[n // 3] = np.nan
    y[n - 2] = np.nan
    if p1 is not None:
        kw["P1"] = np.eye(m) * p1
    if xreg:
        kw["xreg"] = rng.normal(0, 0.3, (n, 2))
        kw["beta"] = bt.normal_prior(np.zeros(2), 0.0, 1.0)
    return bt.bsm_ng(y, **kw)


def airquality_model(bt, dtype):
    """bssm's README example as the JAX package's zoo benchmark sets it up:
    ``bsm_lg`` level + slope on airquality Ozone with Wind and Temp as
    regressors, n = 153, m = 2, d = 5."""
    aq = bt.airquality()
    return bt.bsm_lg(aq["Ozone"], xreg=np.column_stack([aq["Wind"],
                                                         aq["Temp"]]),
                     beta=bt.normal_prior(np.zeros(2), 0.0, 1.0),
                     sd_y=bt.gamma_prior(1.0, 2.0, 0.01),
                     sd_level=bt.gamma_prior(1.0, 2.0, 0.01),
                     sd_slope=bt.gamma_prior(1.0, 2.0, 0.01),
                     dtype=dtype, device="cuda")


def gamma_airquality_model(bt, dtype):
    """The JAX package's ``gamma_airquality_N10`` bench row (bench.py:205-
    219), the reference's own anchor model: ``bsm_ng`` gamma level + slope
    on airquality Ozone (37 missing) with Wind and Temp as regressors,
    ``beta`` normal(0, 1), ``phi`` and the sds with gamma priors; n = 153,
    m = 2, d = 5."""
    aq = bt.airquality()
    return bt.bsm_ng(aq["Ozone"], xreg=np.column_stack([aq["Wind"],
                                                         aq["Temp"]]),
                     beta=bt.normal_prior(np.zeros(2), 0.0, 1.0),
                     distribution="gamma", phi=bt.gamma_prior(1.0, 2.0, 0.01),
                     sd_level=bt.gamma_prior(1.0, 2.0, 0.1),
                     sd_slope=bt.gamma_prior(1.0, 2.0, 0.1), dtype=dtype,
                     device="cuda")


def lg_sweep_model(bt, m: int, dtype, n: int = 40):
    """A small bsm_lg with state dimension ``m`` (1: level, 2: level +
    slope, 3: level + seasonal(3), 4: level + slope + seasonal(3)), three
    missing observations and two regressors (time-varying D); m = 0 gives
    an ar1_lg, whose initial state and C vary over rows."""
    rng = np.random.default_rng(200 + m)
    y = np.cumsum(rng.normal(0, 0.3, n)) + rng.normal(0, 0.5, n)
    y[[3, n // 2, n - 1]] = np.nan
    if m == 0:
        return bt.ar1_lg(y, rho=bt.uniform_prior(0.7, -0.999, 0.999),
                         sigma=bt.halfnormal_prior(0.3, 1.0),
                         mu=bt.normal_prior(0.0, 0.0, 2.0),
                         sd_y=bt.halfnormal_prior(0.5, 1.0), dtype=dtype,
                         device="cuda")
    kw = dict(sd_y=bt.halfnormal_prior(0.5, 1.0),
              sd_level=bt.halfnormal_prior(0.3, 1.0),
              xreg=rng.normal(0, 1.0, (n, 2)),
              beta=bt.normal_prior(np.zeros(2), 0.0, 1.0), dtype=dtype,
              device="cuda")
    if m in (2, 4):
        kw["sd_slope"] = bt.halfnormal_prior(0.05, 0.1)
    if m in (3, 4):
        kw["sd_seasonal"] = bt.halfnormal_prior(0.2, 1.0)
        kw["period"] = 3
    return bt.bsm_lg(y, **kw)


def monthly_series():
    """A simulated monthly series, n = 144 (twelve years), numpy seed 12: a
    slowly drifting level with a yearly cycle; Poisson counts around its
    exponential, and a Gaussian series of the same shape with a slope."""
    rng = np.random.default_rng(12)
    n = 144
    t = np.arange(n)
    level = np.cumsum(rng.normal(0, 0.03, n))
    season = 0.4 * np.sin(2 * np.pi * t / 12) \
        + 0.2 * np.cos(4 * np.pi * t / 12)
    counts = rng.poisson(np.exp(1.5 + level + season)).astype(float)
    gauss = 20.0 + 0.02 * t + 5.0 * level + 3.0 * season \
        + rng.normal(0, 1.0, n)
    return counts, gauss


def seasonal_models(bt, dtype, device="cuda"):
    """The two models outside the kernels' contract: ``bsm_ng`` Poisson
    level + seasonal with period 12 (m = 12, d = 2) and ``bsm_lg`` level +
    slope + seasonal with period 12 (m = 13, d = 4), on the monthly
    series."""
    counts, gauss = monthly_series()
    ng = bt.bsm_ng(counts, sd_level=bt.halfnormal_prior(0.05, 1.0),
                   sd_seasonal=bt.halfnormal_prior(0.05, 1.0), period=12,
                   distribution="poisson", dtype=dtype, device=device)
    lg = bt.bsm_lg(gauss, sd_y=bt.halfnormal_prior(1.0, 5.0),
                   sd_level=bt.halfnormal_prior(0.1, 1.0),
                   sd_slope=bt.halfnormal_prior(0.01, 0.1),
                   sd_seasonal=bt.halfnormal_prior(0.1, 1.0), period=12,
                   dtype=dtype, device=device)
    return ng, lg


def sv_series(n: int = 945, seed: int = 21) -> np.ndarray:
    """A stochastic-volatility series of the length of bssm's ``exchange``
    data (n = 945, which the repo does not hold), simulated with numpy at
    rho 0.98, sd_ar 0.15, sigma 0.6 from a stationary start."""
    rng = np.random.default_rng(seed)
    rho, sd_ar, sigma = 0.98, 0.15, 0.6
    h = np.empty(n)
    h[0] = rng.normal(0.0, sd_ar / np.sqrt(1.0 - rho ** 2))
    for t in range(1, n):
        h[t] = rho * h[t - 1] + sd_ar * rng.normal()
    return sigma * np.exp(h / 2.0) * rng.normal(size=n)


def svm_model(bt, dtype, n: int = 945, **kw):
    """The JAX package's exchange-rate SV row (benchmarks/zoo_tpu.py:
    186-206): ``svm`` of the "sigma" type on ``sv_series``, rho
    uniform(-0.999, 0.999) from 0.98, sd_ar halfnormal(1) from 0.15, sigma
    halfnormal(2) from 0.6; ``mu`` given instead gives the "mu" type."""
    third = kw or dict(sigma=bt.halfnormal_prior(0.6, 2.0))
    return bt.svm(sv_series(n), rho=bt.uniform_prior(0.98, -0.999, 0.999),
                  sd_ar=bt.halfnormal_prior(0.15, 1.0), dtype=dtype,
                  device="cuda", **third)


def ar1_negbin_model(bt, dtype):
    """The JAX package's ``ar1_ng(negbin,pm)`` zoo row (benchmarks/
    zoo_tpu.py:143-148) on the main path's series: rho uniform(-0.999,
    0.999) from 0.8, sigma halfnormal(1) from 0.3, mu normal(0, 2) from 1,
    phi halfnormal(5) from 2; n = 153, m = 1, d = 4, and T, R, a1, P1 and
    C vary over rows."""
    return bt.ar1_ng(main_path_series(),
                     rho=bt.uniform_prior(0.8, -0.999, 0.999),
                     sigma=bt.halfnormal_prior(0.3, 1.0),
                     mu=bt.normal_prior(1.0, 0.0, 2.0),
                     phi=bt.halfnormal_prior(2.0, 5.0),
                     distribution="negative binomial", dtype=dtype,
                     device="cuda")


def ssm_ung_model(bt, dtype):
    """The main path's model written as ``ssm_ung``: Poisson level + slope,
    Z = (1, 0), T = [[1, 1], [0, 1]], a1 = 0, P1 = 100 I, theta the log
    sds, R = diag(exp theta) per row from a batched ``update_fn``, and a
    batched ``prior_fn`` giving the main path's prior on the log scale:
    halfnormal(1) on the level sd and halfnormal(0.1) on the slope sd at
    exp(theta), plus the log-Jacobian theta.  The same posterior as
    ``psi_N10``'s, through the user functions."""
    scale = torch.tensor([1.0, 0.1], dtype=dtype, device="cuda")

    def update_fn(theta):
        return {"R": torch.diag_embed(torch.exp(theta))[:, None]}

    def prior_fn(theta):
        return (theta - 0.5 * torch.square(torch.exp(theta) / scale)).sum(-1)

    return bt.ssm_ung(main_path_series(), Z=np.array([1.0, 0.0]),
                      T=np.array([[1.0, 1.0], [0.0, 1.0]]),
                      R=np.diag([0.1, 0.01]), distribution="poisson",
                      P1=100.0 * np.eye(2), init_theta=np.log([0.1, 0.01]),
                      update_fn=update_fn, prior_fn=prior_fn,
                      theta_names=("log_sd_level", "log_sd_slope"),
                      dtype=dtype, device="cuda")


def ssm_ulg_model(bt, dtype):
    """airquality Ozone (37 missing) as a local linear trend ``ssm_ulg``:
    Z = (1, 0), T = [[1, 1], [0, 1]], a1 = 0, P1 = 100 I; theta the log
    sds (y, level, slope), H = exp theta_1 and R = diag(exp theta_2,
    exp theta_3) per row from a batched ``update_fn``; ``prior_fn`` gives
    each sd ``lg_theta``'s gamma(2, 0.01) prior at exp(theta) plus the
    log-Jacobian.  n = 153, m = 2, d = 3."""
    def update_fn(theta):
        return {"H": torch.exp(theta[:, :1]),
                "R": torch.diag_embed(torch.exp(theta[:, 1:]))[:, None]}

    def prior_fn(theta):
        return (2.0 * theta - 0.01 * torch.exp(theta)).sum(-1)

    return bt.ssm_ulg(bt.airquality()["Ozone"], Z=np.array([1.0, 0.0]),
                      H=1.0, T=np.array([[1.0, 1.0], [0.0, 1.0]]),
                      R=np.eye(2), P1=100.0 * np.eye(2),
                      init_theta=np.zeros(3), update_fn=update_fn,
                      prior_fn=prior_fn,
                      theta_names=("log_sd_y", "log_sd_level",
                                   "log_sd_slope"),
                      dtype=dtype, device="cuda")


def thetas_around_init(model, B: int, seed: int, spread: float = 0.5):
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(seed)
    t0 = torch.as_tensor(model.theta_init, dtype=model.dtype, device=dev)
    return t0 + spread * torch.randn((B, t0.shape[0]), dtype=model.dtype,
                                     device=dev, generator=g)


# ---------------------------------------------------------------------------
# kernel against plain version
# ---------------------------------------------------------------------------

def k1_passes(spec, mode0, conv_tol: float, niter_sum: int,
              label: str) -> dict:
    """K1's own count of its passes, the program's ``laplace.passes``: in
    each staging that holds the shape, two ``laplace_solve`` calls inside
    one traced fit must count twice the ``niter`` sum (the second call adds
    to the counter, it does not overwrite it)."""
    from bssm_tpu_torch.diagnostics import profiling
    from bssm_tpu_torch.ops import cuda_kalman as ck
    out = {"niter_sum": niter_sum}
    for st in ck.staging_options(spec.n, spec.m, spec.y.element_size()):
        if st is None:
            continue
        with profiling.tracing(), profiling.fit("k1", 0, "bssm.fit"):
            sums = [int(ck.laplace_solve(spec, mode0, conv_tol, 100,
                                         staging=st)[2].sum())
                    for _ in range(2)]
            torch.cuda.synchronize()
        got = profiling.records()[-1].counters["laplace.passes"]
        key = "shared" if st.shared else "device"
        out[key] = got
        if got != 2 * niter_sum or sums != [niter_sum] * 2:
            FAILURES.append({"what": "laplace_solve's pass counter",
                             "label": label, "staging": key, "counted": got,
                             "niter_sums": sums, "niter_sum": niter_sum})
    return out


def check_kernels(model, B: int, N: int, label: str, timed: bool,
                  seed: int = 7, k1_only: bool = False,
                  spread: float = 0.5) -> dict:
    """Runs the three kernels (``k1_only``: laplace_solve alone) and their
    plain versions on the same inputs on the card, at B thetas ``spread``
    around the initial one; returns errors and (when ``timed``)
    milliseconds."""
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.inference import particle as pmod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    from bssm_tpu_torch.ops import kalman

    dt = model.dtype
    f64 = dt == torch.float64
    strict = f64
    m = model.extra["m"]
    tol = (lambda k: F64_TOL) if f64 else (lambda k: F32_TOL[k])
    spec = model.build(thetas_around_init(model, B, seed, spread))
    conv_tol = max(1e-8, 50.0 * float(torch.finfo(dt).eps))
    mode0 = spec.initial_mode
    out = {"label": label, "B": B, "n": spec.n, "m": m, "N": N,
           "dtype": str(dt).replace("torch.", ""),
           "family": spec.distribution, "checks": []}

    # K1 ------------------------------------------------------------------
    k_mode, k_prev, k_niter, k_diff, k_ll = ck.laplace_solve(
        spec, mode0, conv_tol, 100)
    p_mode, p_prev, p_niter, p_diff, p_ll = amod.laplace_solve_plain(
        spec, mode0, conv_tol, 100)
    torch.cuda.synchronize()
    out["checks"].append(compare("laplace_solve.mode", k_mode, p_mode,
                                 tol("mode"), strict))
    out["checks"].append(compare("laplace_solve.ll", k_ll, p_ll, tol("ll"),
                                 strict))
    same_pass = k_niter == p_niter
    out["laplace_niter_mean"] = float(k_niter.double().mean())
    out["laplace_niter_max"] = int(k_niter.max())
    out["laplace_rows_other_pass_count"] = float((~same_pass).double().mean())
    if f64:
        # same stopping pass -> the linearisation point agrees as well
        out["checks"].append(compare("laplace_solve.prev", k_prev, p_prev,
                                     F64_TOL, True))
        if not bool(same_pass.all()):
            FAILURES.append({"what": "laplace_solve.niter", "label": label})
    if int(k_niter.max()) >= 100:
        FAILURES.append({"what": "laplace_solve did not converge",
                         "label": label})
    out["staging"] = ck.laplace_staging(
        spec.n, m, spec.y.element_size(), B, ck._sm_count(0))._asdict()
    out["k1_passes"] = k1_passes(spec, mode0, conv_tol, int(k_niter.sum()),
                                 label)
    if k1_only:
        return out

    # K2 (both sides get the kernel's approximation) ----------------------
    ar = amod.approximate(spec, conv_tol, 100)
    g = ar.gaussian(spec)
    k_ahat, k_Lb, k_Ab = ck.rts_factors(g)
    p_ahat, p_Lb, p_Ab = kalman.smoother_bwd_factors(g)
    torch.cuda.synchronize()
    out["checks"].append(compare(
        "rts_factors.ahat", k_ahat, p_ahat,
        tol("ahat_m3" if m >= 3 else "ahat"), strict))
    out["checks"].append(compare("rts_factors.Ab", k_Ab, p_Ab, tol("Ab"),
                                 strict))
    out["checks"].append(compare("rts_factors.LbLbT", outer(k_Lb),
                                 outer(p_Lb), tol("LL"), strict))
    if m <= 2 and f64:
        # closed-form eigensystem: same column convention on both sides
        out["checks"].append(compare("rts_factors.Lb", k_Lb, p_Lb, F64_TOL,
                                     True))

    # K3 (both sides get the kernel's factors) ----------------------------
    sc = amod.mode_scales(spec, ar)
    zero = torch.zeros(B, dtype=dt, device="cuda")
    al = amod.ApproxLoglik(ar, sc, zero, zero)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    eps = torch.randn((B, spec.n + 1, N, m), dtype=dt, device="cuda",
                      generator=gen)
    us = torch.rand((B, spec.n, N), dtype=dt, device="cuda", generator=gen)
    k_lw = ck.psi_logw(spec, al, k_ahat, k_Lb, k_Ab, eps, us)
    p_lw = pmod.psi_logw_scan(spec, al, eps, us,
                              factors=(k_ahat, k_Lb, k_Ab))
    torch.cuda.synchronize()
    out["checks"].append(compare("psi_logw.logw", k_lw, p_lw, tol("logw"),
                                 strict))
    out["psi_logw_abs_max"] = float(k_lw.abs().max())

    if timed:
        out["ms"] = {
            "laplace_solve": time_ms(lambda: ck.laplace_solve(
                spec, mode0, conv_tol, 100)),
            "rts_factors": time_ms(lambda: ck.rts_factors(g)),
            "psi_logw": time_ms(lambda: ck.psi_logw(
                spec, al, k_ahat, k_Lb, k_Ab, eps, us)),
        }
        out["plain_ms"] = {
            "laplace_solve": time_ms(lambda: amod.laplace_solve_plain(
                spec, mode0, conv_tol, 100), reps=1, warmup=0),
            "rts_factors": time_ms(lambda: kalman.smoother_bwd_factors(g),
                                   reps=1, warmup=0),
            "psi_logw": time_ms(lambda: pmod.psi_logw_scan(
                spec, al, eps, us, factors=(k_ahat, k_Lb, k_Ab)),
                reps=1, warmup=0),
        }
        out["bounds"] = bounds(B, spec.n, m, N, dt,
                               float(k_niter.double().sum()))
        # the bare kernels; a laplace_solve call is one launch
        k1 = lambda: ck.laplace_solve(spec, mode0, conv_tol, 100)  # noqa
        out["bare_ms"] = {
            "laplace_solve": bare_ms(k1, "bssm_laplace_solve"),
            "rts_factors": bare_ms(lambda: ck.rts_factors(g),
                                   "bssm_rts_factors"),
            "psi_logw": bare_ms(lambda: ck.psi_logw(
                spec, al, k_ahat, k_Lb, k_Ab, eps, us), "bssm_psi_logw")}
        out["one_kernel"] = one_kernel(k1, "laplace_solve")
    return out


def rts_staging_cases(bt) -> list:
    """``(label, model, B)`` on both sides of each limit of
    ``rts_geometry``: the wave limit at the main path's model in float64
    (the most rows ``RTS_SHARED_WAVES`` waves of shared-staged blocks hold,
    and one more), the footprint limit at m = 2 (float64: n = 723 fits, 724
    does not; float32: n = 1449 and 1450) and m = 4 float64 (n = 256 fits,
    257 and 1200 do not), and m = 1, 3 at small shapes."""
    from bssm_tpu_torch.ops import cuda_kalman as ck
    last = int(ck.RTS_SHARED_WAVES * ck.rts_shared_rows(153, 2, 8,
                                                         ck._sm_count(0)))
    m64 = main_path_model(bt, torch.float64)
    f32, f64 = torch.float32, torch.float64
    sw = lambda m, dt, n: sweep_model(bt, "poisson", m, dt, n=n)  # noqa
    return [(f"main f64 B={last} (last shared)", m64, last),
            (f"main f64 B={last + 1} (first device)", m64, last + 1),
            ("m=2 f64 n=723", sw(2, f64, 723), 64),
            ("m=2 f64 n=724", sw(2, f64, 724), 64),
            ("m=2 f32 n=1449", sw(2, f32, 1449), 64),
            ("m=2 f32 n=1450", sw(2, f32, 1450), 64),
            ("m=4 f64 n=256", sw(4, f64, 256), 64),
            ("m=4 f64 n=257", sw(4, f64, 257), 64),
            ("m=4 f64 n=1200", sw(4, f64, 1200), 64),
            ("m=1 f32 n=40", sw(1, f32, 40), 256),
            ("m=3 f64 n=40", sw(3, f64, 40), 256)]


def scaled_err(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Largest |got - ref| / (1 + |ref|) and the share of entries above
    1e-3, over the finite entries."""
    got, ref = got.double(), ref.double()
    fin = torch.isfinite(got) & torch.isfinite(ref)
    d = torch.where(fin, (got - ref).abs() / (1 + ref.abs()),
                    torch.zeros_like(ref))
    return {"max": float(d.max()), "share_above_1e-3": float(
        (d > 1e-3).double().mean())}


def check_rts_staging(bt) -> list:
    """K2 (``rts_factors``) on both sides of its staging rule
    (``rts_staging_cases``): the other staging, forced, against the rule's
    launch to the bit (both compute every factor by the same operations;
    only where the moments are staged differs), and the rule's launch
    against the plain version at the tolerances of ``check_kernels``.  A
    float32 series of n = 1449 steps is conditioned past those tolerances
    (ill-conditioned gains: both float32 versions lie up to 14% from the
    float64 one in Ab, and 0.9% from each other); there the kernel and the
    plain version are each held against the plain version in float64, and
    the kernel's largest error and share above 1e-3 may not exceed the
    plain version's by more than a tenth.  The wrapper always takes the
    rule's staging, so the check forces the other by replacing
    ``rts_geometry`` for the call."""
    from unittest import mock
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    from bssm_tpu_torch.ops import kalman
    out = []
    sms = ck._sm_count(0)
    for label, model, B in rts_staging_cases(bt):
        dt = model.dtype
        f64 = dt == torch.float64
        m = model.extra["m"]
        tol = (lambda k: F64_TOL) if f64 else (lambda k: F32_TOL[k])
        spec = model.build(thetas_around_init(model, B, 43))
        conv_tol = max(1e-8, 50.0 * float(torch.finfo(dt).eps))
        g = amod.approximate(spec, conv_tol, 100).gaussian(spec)
        item = spec.y.element_size()
        geo = ck.rts_geometry(spec.n, m, item, B, sms)
        other = ck.RtsGeometry(ck.RTS_ROWS_DEVICE, False,
                               ck.RTS_ROWS_DEVICE * ck.rts_sys_elems(m)
                               * item) if geo.shared else \
            ck.RtsGeometry(ck.RTS_ROWS_SHARED, True, ck.RTS_ROWS_SHARED * (
                ck.rts_sys_elems(m) + ck.rts_row_elems(spec.n, m)) * item)
        k = ck.rts_factors(g)
        p = kalman.smoother_bwd_factors(g)
        torch.cuda.synchronize()
        res = {"label": label, "B": B, "n": spec.n, "m": m,
               "dtype": str(dt).replace("torch.", ""),
               "geometry": geo._asdict()}
        if f64 or spec.n <= 153:
            res["checks"] = [
                compare("rts_factors.ahat", k[0], p[0],
                        tol("ahat_m3" if m >= 3 else "ahat"), f64),
                compare("rts_factors.Ab", k[2], p[2], tol("Ab"), f64),
                compare("rts_factors.LbLbT", outer(k[1]), outer(p[1]),
                        tol("LL"), f64)]
        else:
            r = kalman.smoother_bwd_factors(type(g)(*[x.double()
                                                      for x in g]))
            acc = {}
            for name, a, b, c in (("ahat", k[0], p[0], r[0]),
                                  ("Ab", k[2], p[2], r[2]),
                                  ("LbLbT", outer(k[1]), outer(p[1]),
                                   outer(r[1]))):
                ek, ep = scaled_err(a, c), scaled_err(b, c)
                acc[name] = {"kernel_vs_f64": ek, "plain_vs_f64": ep,
                             "kernel_vs_plain": scaled_err(a, b)}
                if ek["max"] > 1.1 * ep["max"] + 1e-6 or \
                        ek["share_above_1e-3"] > \
                        1.1 * ep["share_above_1e-3"] + 1e-6:
                    FAILURES.append({"what": f"rts_factors.{name} less "
                                             "accurate than the plain "
                                             "version", "label": label,
                                     **acc[name]})
            res["against_float64"] = acc
            res["checks"] = []
        if other.smem_bytes <= ck.SMEM_LIMIT:
            with mock.patch.object(ck, "rts_geometry",
                                   lambda *_, geo=other: geo):
                o = ck.rts_factors(g)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(k, o))
            res["other_geometry"] = other._asdict()
            res["other_staging_bitwise_equal"] = same
            if not same:
                FAILURES.append({"what": "rts_factors: the two stagings "
                                         "differ", "label": label})
        out.append(res)
        del k, p, g, spec
        torch.cuda.empty_cache()
    picks = {r["geometry"]["shared"] for r in out}
    if picks != {True, False}:
        FAILURES.append({"what": "rts_factors: a staging was never picked",
                         "picks": sorted(picks)})
    return out


PSI_PARTICLES = (1, 7, 8, 10, 16, 17, 32)


def check_psi_particles(model, B: int, label: str, seed: int = 47) -> dict:
    """K3 (``psi_logw``) against its plain version at every particle count
    of ``PSI_PARTICLES``, on both sides of each segment width (1, 8, 16
    and 32 lanes a row), with the kernel's own factors on both sides, at
    the tolerance of ``check_kernels``."""
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.inference import particle as pmod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    dt = model.dtype
    f64 = dt == torch.float64
    m = model.extra["m"]
    spec = model.build(thetas_around_init(model, B, seed))
    conv_tol = max(1e-8, 50.0 * float(torch.finfo(dt).eps))
    ar = amod.approximate(spec, conv_tol, 100)
    fac = ck.rts_factors(ar.gaussian(spec))
    zero = torch.zeros(B, dtype=dt, device="cuda")
    al = amod.ApproxLoglik(ar, amod.mode_scales(spec, ar), zero, zero)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    out = {"label": label, "B": B, "n": spec.n, "m": m,
           "dtype": str(dt).replace("torch.", ""), "checks": []}
    for N in PSI_PARTICLES:
        eps = torch.randn((B, spec.n + 1, N, m), dtype=dt, device="cuda",
                          generator=gen)
        us = torch.rand((B, spec.n, N), dtype=dt, device="cuda",
                        generator=gen)
        k = ck.psi_logw(spec, al, *fac, eps, us)
        p = pmod.psi_logw_scan(spec, al, eps, us, factors=fac)
        torch.cuda.synchronize()
        c = compare(f"psi_logw.logw N={N}", k, p,
                    F64_TOL if f64 else F32_TOL["logw"], f64)
        c["segment"] = list(ck.psi_segment(N))
        out["checks"].append(c)
    return out


def kf_step_ops(m: int) -> int:
    """Floating-point operations of one masked Joseph-form Kalman step with
    its prediction (``kf_step`` of csrc/kalman_common.cuh), a multiply-add
    counted as 2, divide, log and the mask as 12."""
    mm = m * m
    return 2 * mm + 4 * m + 3 * m + 2 * (2 * m ** 3 + mm) + 3 * mm \
        + 2 * (2 * m ** 3) + 2 * mm + 2 * mm + 12


def bwd_mean_ops(m: int) -> int:
    """Operations of one step of the fast smoother's backward mean pass
    (``bwd_mean_step``): the gain again, T K, L' r and T' r, a_t + P_t r."""
    mm = m * m
    return 2 * mm + 2 * mm + 6 * mm + 2 * mm + 4 * m


def laplace_pass_ops(m: int) -> int:
    """Operations of one time step of a Laplace pass (``laplace_pass`` of
    csrc/laplace_solve.cu): the match (exp, divide and a few products, 12),
    the Kalman step, the backward mean step, the new signal and its squared
    change."""
    return kf_step_ops(m) + 12 + bwd_mean_ops(m) + 2 * m + 3


def roofline(byts: float, ops: float) -> dict:
    t_b = byts / PEAK_BYTES_PER_S * 1e3
    t_o = ops / PEAK_F32_FLOPS * 1e3
    return {"bytes": byts, "operations": ops, "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def bounds(B: int, n: int, m: int, N: int, dt, total_passes: float) -> dict:
    """Least time the card could take for each kernel's work on these
    inputs: the larger of (bytes each input is read and each output is
    written once) / memory rate and (floating-point operations) / float32
    peak.  Operation counts are per time step, a multiply-add counted as 2;
    ``total_passes`` is the sum over rows of the Laplace passes this run's
    data needed."""
    it = torch.finfo(dt).bits // 8
    mm = m * m
    sys_rows = 3 * m + 3 * mm
    kf = kf_step_ops(m)
    k1_ops = total_passes * n * laplace_pass_ops(m)
    k1_bytes = it * (3 * n + 1 + (sys_rows + 1) * B + 2 * B * n + 2 * B) \
        + 4 * B
    # filter + per step: pinv (eig 2x2 ~ 40), J, Joseph Sigma, factor
    k2_step = kf + 2 * (2 * m ** 3) + 2 * mm + 6 * (2 * m ** 3) + 80 + 4 * mm
    k2_ops = B * n * k2_step
    k2_bytes = it * (2 * B * n + 1 + sys_rows * B
                     + B * (n + 1) * (m + 2 * mm))
    # per particle and step: ancestor search (N compares), propagate
    # (2 m^2 multiply-adds twice), signal, log-weight (exp, log ~ 30),
    # reductions (3 log2(32) shuffles ~ 15)
    k3_step = N + 8 * mm + 2 * m + 30 + 15
    k3_ops = B * n * N * k3_step
    k3_bytes = it * (B * (n + 1) * N * m + B * n * N
                     + B * (n + 1) * (m + 2 * mm) + 3 * B * n + 2 * n + 1
                     + B * (m + 1) + B)
    return {name: roofline(byts, ops)
            for name, ops, byts in (("laplace_solve", k1_ops, k1_bytes),
                                    ("rts_factors", k2_ops, k2_bytes),
                                    ("psi_logw", k3_ops, k3_bytes))}


def step_bounds(B: int, n: int, m: int, dt) -> dict:
    """Least time of one ``laplace_step`` launch: one Laplace pass of every
    row; bytes of the shared y, u and D series, the packed system, the
    (B, n) mode in and out and the (B,) log-likelihood and change."""
    it = torch.finfo(dt).bits // 8
    sys_rows = 3 * m + 3 * m * m
    ops = B * n * laplace_pass_ops(m)
    byts = it * (3 * n + (sys_rows + 1) * B + 2 * B * n + 2 * B)
    return roofline(byts, ops)


def check_step(model, B: int, label: str, timed: bool, seed: int = 31,
               spread: float = 0.1) -> dict:
    """K8 (``laplace_step``) against its plain version on the same inputs
    on the card: one pass at a perturbed initial mode, with the tolerances
    of K1.  B = 1 hands the kernel one unbatched model, as the single-model
    solve does."""
    from bssm_tpu_torch.core.spec import drop_batch
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    dt = model.dtype
    f64 = dt == torch.float64
    tol = (lambda k: F64_TOL) if f64 else (lambda k: F32_TOL[k])
    th = thetas_around_init(model, B, seed)
    spec = drop_batch(model.build(th[0])) if B == 1 else model.build(th)
    gen = torch.Generator(device=model.device).manual_seed(seed + 1)
    mode = (spec.initial_mode + spread * torch.randn(
        (B, spec.n), dtype=dt, device=model.device,
        generator=gen)).contiguous()
    got = ck.laplace_step(spec, mode)
    ref = amod._laplace_step(spec, mode)
    torch.cuda.synchronize()
    out = {"label": label, "B": B, "n": spec.n, "m": spec.m,
           "dtype": str(dt).replace("torch.", ""),
           "family": spec.distribution, "checks": [
               compare(f"laplace_step.{k}", g, r, tol(t), f64)
               for k, t, g, r in zip(("mode", "ll", "diff"),
                                     ("mode", "ll", "mode"), got, ref)]}
    geo = ck.fs_geometry(spec.n, spec.m, spec.y.element_size(), B,
                         ck._sm_count(0), step=True)
    out["geometry"] = geo._asdict()
    out["layouts_bit_equal"] = step_layouts_equal(spec, mode, got, label)
    if timed:
        out["ms"] = time_ms(lambda: ck.laplace_step(spec, mode))
        out["plain_ms"] = time_ms(lambda: amod._laplace_step(spec, mode),
                                  reps=1, warmup=0)
        out["bounds"] = step_bounds(B, spec.n, spec.m, dt)
        out["bare_ms"] = bare_ms(lambda: ck.laplace_step(spec, mode),
                                 "bssm_laplace_step")
        out["one_kernel"] = one_kernel(lambda: ck.laplace_step(spec, mode),
                                       "laplace_step")
    return out


def step_layouts(spec, B: int) -> dict:
    """The launch layouts of ``laplace_step`` for this spec: the rule's
    (``fs_geometry``), the two of ``fs_options`` (the whole series in
    shared memory where it fits, one row a block for one model; tiles with
    checkpoints), and at B = 1 the whole-series block on one and two warps
    as well as the rule's four."""
    from bssm_tpu_torch.ops import cuda_kalman as ck
    n, m, item = spec.n, spec.m, spec.y.element_size()
    out = {"rule": ck.fs_geometry(n, m, item, B, ck._sm_count(0),
                                  step=True)}
    opts = ck.fs_options(n, m, item, step=True,
                         rows=1 if B == 1 else ck.FS_ROWS_SHARED)
    out.update({k: g for k, g in opts.items() if g is not None})
    if B == 1 and opts["shared"] is not None:
        for threads in (32, 64):
            out[f"threads={threads}"] = opts["shared"]._replace(
                threads=threads)
    return out


def step_layouts_equal(spec, mode, got, label: str) -> bool:
    """Every layout of ``step_layouts`` gives ``got``'s outputs to the bit
    (a failure otherwise)."""
    from bssm_tpu_torch.ops import cuda_kalman as ck
    B = mode.shape[0]
    equal = True
    for name, geo in step_layouts(spec, B).items():
        other = ck.laplace_step(spec, mode, staging=geo)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, other)):
            equal = False
            FAILURES.append({"what": f"laplace_step: layout {name} differs "
                                     "from the rule's", "label": label,
                             "geometry": geo._asdict()})
    return equal


def step_staging_readings(bt) -> list:
    """``laplace_step`` at n = 153 over m = 1..4 (the main path's model at
    m = 2, the Poisson sweep models else), float32 and float64, B = 1, 4096,
    16384: the bare kernel under each layout of ``step_layouts``, timed in
    turns (forward through the list, then backward), the waves of the
    whole-series layout, the layout the rule picks, all equal to the bit
    (``step_layouts_equal``).  The readings ``STEP_SHARED_WAVES`` is set
    from."""
    from bssm_tpu_torch.core.spec import drop_batch
    from bssm_tpu_torch.ops import cuda_kalman as ck
    out = []
    sms = ck._sm_count(0)
    for dt in (torch.float32, torch.float64):
        for m in (1, 2, 3, 4):
            model = main_path_model(bt, dt) if m == 2 \
                else sweep_model(bt, "poisson", m, dt, n=153)
            for B in (1, 4096, 16384):
                th = thetas_around_init(model, B, 31)
                spec = drop_batch(model.build(th[0])) if B == 1 \
                    else model.build(th)
                mode = spec.initial_mode.expand(B, spec.n).contiguous()
                lay = step_layouts(spec, B)
                r = {"dtype": str(dt).replace("torch.", ""), "m": m, "B": B,
                     "geometry": {k: g._asdict() for k, g in lay.items()},
                     "waves_shared": (ck.fs_waves(lay["shared"], B, sms)
                                      if "shared" in lay else None),
                     "picked": [k for k, g in lay.items() if k != "rule"
                                and g == lay["rule"]][0],
                     "bare_ms": {}}
                got = ck.laplace_step(spec, mode)
                r["bit_equal"] = step_layouts_equal(
                    spec, mode, got, f"step_staging {r['dtype']} m={m} "
                                     f"B={B}")
                names = [k for k in lay if k != "rule"]
                for name in names + list(reversed(names)):
                    r["bare_ms"].setdefault(name, []).append(bare_ms(
                        lambda: ck.laplace_step(spec, mode,
                                                staging=lay[name]),
                        "bssm_laplace_step"))
                r["faster"] = min(r["bare_ms"],
                                  key=lambda k: min(r["bare_ms"][k]))
                out.append(r)
    return out


def check_single_solve(model, B: int, label: str) -> dict:
    """The single-model solve (the host loop over K8 with per-row masking,
    ``laplace_solve_steps``) against K1 on the same batch, float64: mode,
    previous mode and log-likelihood inside K1's float64 tolerance, the
    pass count of every row equal."""
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    spec = model.build(thetas_around_init(model, B, 37))
    steps = amod.laplace_solve_steps(spec, spec.initial_mode, 1e-8, 100)
    k1 = ck.laplace_solve(spec, spec.initial_mode, 1e-8, 100)
    torch.cuda.synchronize()
    out = {"label": label, "B": B, "checks": [
        compare(f"laplace_solve_steps.{k} vs laplace_solve", a, b, F64_TOL,
                True)
        for k, a, b in zip(("mode", "prev"), steps[:2], k1[:2])]}
    out["checks"].append(compare("laplace_solve_steps.ll vs laplace_solve",
                                 steps[4], k1[4], F64_TOL, True))
    out["niter_equal"] = bool(torch.equal(steps[2], k1[2]))
    out["niter_mean"] = float(k1[2].double().mean())
    if not out["niter_equal"]:
        FAILURES.append({"what": "laplace_solve_steps.niter", "label": label})
    return out


def leaf_layouts(spec, B: int, series) -> dict:
    """The spec as built, every leaf broadcast as an expand view (batch
    stride 0 where it was shared), and every leaf and the ``series`` a
    contiguous per-row copy, T and P1 with a non-contiguous core: three
    layouts of the same values, which the kernels must read alike."""
    import dataclasses
    from bssm_tpu_torch.core.spec import CORE_NDIM, NGSpec
    ng = isinstance(spec, NGSpec)
    names = ["Z", "T", "R", "a1", "P1", "C"] + (["phi"] if ng else [])
    expand, per_row = {}, {}
    for f in names + list(series):
        x = getattr(spec, f)
        if x.dim() == CORE_NDIM[f]:
            x = x.unsqueeze(0)
        ex = x.expand(B, *x.shape[1:])
        if f not in series:
            expand[f] = ex
        pr = ex.contiguous()
        if f in ("T", "P1"):
            pr = pr.transpose(-1, -2).contiguous().transpose(-1, -2)
        per_row[f] = pr
    rep = (lambda **kw: dataclasses.replace(spec, **kw)) if ng \
        else (lambda **kw: spec._replace(**kw))
    return {"as built": spec, "expanded": rep(**expand),
            "per row": rep(**per_row)}


def check_layouts(ng_model, lg_model, B: int, label: str,
                  timed: bool) -> dict:
    """K1 and K6 on the leaf layouts of ``leaf_layouts`` (K1's y and u per
    row in the last one, which K1 then reads from device memory instead of
    staging them), each against the plain version on the spec as built,
    with the tolerances of check_kernels and check_lg."""
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    from bssm_tpu_torch.ops import kalman
    dt = ng_model.dtype
    f64 = dt == torch.float64
    tol = (lambda k: F64_TOL) if f64 else (lambda k: F32_TOL[k])
    spec = ng_model.build(thetas_around_init(ng_model, B, 41))
    conv_tol = max(1e-8, 50.0 * float(torch.finfo(dt).eps))
    mode0 = spec.initial_mode
    ref = amod.laplace_solve_plain(spec, mode0, conv_tol, 100)
    g = lg_model.build(thetas_around_init(lg_model, B, 43, spread=0.3))
    ref_ll = kalman.log_likelihood(g, degenerate=kalman.degenerate_h2rr)
    lg_tol = (F64_TOL, F64_TOL) if f64 else (1e-5, 2e-5)
    out = {"label": label, "B": B, "dtype": str(dt).replace("torch.", ""),
           "checks": [], "ms": {}, "bare_ms": {}}
    lg_lay = leaf_layouts(g, B, ("y", "H"))
    for name, sp in leaf_layouts(spec, B, ("y", "u")).items():
        got = ck.laplace_solve(sp, mode0, conv_tol, 100)
        ll = ck.log_likelihood(lg_lay[name])
        torch.cuda.synchronize()
        out["checks"] += [
            compare(f"laplace_solve.mode [{name}]", got[0], ref[0],
                    tol("mode"), f64),
            compare(f"laplace_solve.ll [{name}]", got[4], ref[4], tol("ll"),
                    f64),
            compare_lg(f"log_likelihood [{name}]", ll, ref_ll, *lg_tol)]
        if f64 and not torch.equal(got[2], ref[2]):
            FAILURES.append({"what": f"laplace_solve.niter [{name}]",
                             "label": label})
        if timed:
            out["ms"][name] = {
                "laplace_solve": time_ms(lambda: ck.laplace_solve(
                    sp, mode0, conv_tol, 100)),
                "log_likelihood": time_ms(
                    lambda: ck.log_likelihood(lg_lay[name]))}
            out["bare_ms"][name] = {
                "laplace_solve": bare_ms(lambda: ck.laplace_solve(
                    sp, mode0, conv_tol, 100), "bssm_laplace_solve"),
                "log_likelihood": bare_ms(
                    lambda: ck.log_likelihood(lg_lay[name]),
                    "bssm_kalman_ll")}
    return out


SWEEP_B = (1024, 2048, 4096, 8192, 16384, 32768)


def staging_sweep(bt) -> list:
    """``laplace_solve`` at n = 153 over B in ``SWEEP_B``, m = 1..4 (the
    main path's model at m = 2) and both dtypes: the bare kernel
    (``bare_ms``) of the staging the wrapper picks, and, where the package
    has ``staging_options``, of each of the two stagings, the waves of the
    shared one, and the two held against each other under the strict
    tolerance of the dtype (F64_TOL, or F32_TOL["mode"] / ["ll"] on every
    entry): they run the same arithmetic.  On a package without
    ``staging_options`` (an earlier one) only the picked staging is timed."""
    from bssm_tpu_torch.ops import cuda_kalman as ck
    both = hasattr(ck, "staging_options")
    out = []
    for dt in (torch.float32, torch.float64):
        f64 = dt == torch.float64
        conv_tol = max(1e-8, 50.0 * float(torch.finfo(dt).eps))
        for m in (1, 2, 3, 4):
            model = main_path_model(bt, dt) if m == 2 \
                else sweep_model(bt, "poisson", m, dt, n=153)
            for B in SWEEP_B:
                spec = model.build(thetas_around_init(model, B, 53))
                mode0 = spec.initial_mode
                r = {"dtype": str(dt).replace("torch.", ""), "m": m, "B": B,
                     "picked_ms": bare_ms(lambda: ck.laplace_solve(
                         spec, mode0, conv_tol, 100), "bssm_laplace_solve")}
                if both:
                    item, sms = spec.y.element_size(), ck._sm_count(0)
                    shared, device = ck.staging_options(spec.n, m, item)
                    picked = ck.laplace_staging(spec.n, m, item, B, sms)
                    r.update(rows_shared=shared.rows,
                             waves_shared=ck.shared_waves(shared, B, sms),
                             picked="shared" if picked.shared else "device")
                    got = {}
                    for name, st in (("shared", shared), ("device", device)):
                        got[name] = ck.laplace_solve(spec, mode0, conv_tol,
                                                     100, staging=st)
                        r[name + "_ms"] = bare_ms(
                            lambda: ck.laplace_solve(spec, mode0, conv_tol,
                                                     100, staging=st),
                            "bssm_laplace_solve")
                    torch.cuda.synchronize()
                    r["faster"] = min(("shared", "device"),
                                      key=lambda k: r[k + "_ms"])
                    r["bit_equal"] = all(
                        torch.equal(a, b) for a, b in
                        zip(got["shared"][2:4], got["device"][2:4])) and all(
                        torch.equal(a.nan_to_num(), b.nan_to_num()) for a, b
                        in zip(got["shared"][:2] + got["shared"][4:],
                               got["device"][:2] + got["device"][4:]))
                    tag = f" [{r['dtype']} m={m} B={B}]"
                    r["checks"] = [
                        compare("shared vs device mode" + tag,
                                got["device"][0], got["shared"][0],
                                F64_TOL if f64 else F32_TOL["mode"], True),
                        compare("shared vs device ll" + tag,
                                got["device"][4], got["shared"][4],
                                F64_TOL if f64 else F32_TOL["ll"], True)]
                out.append(r)
    return out


def rts_staging_sweep(bt) -> list:
    """``rts_factors`` at n = 153 over B = 1024, 4096, 16384, m = 1..4 (the
    main path's model at m = 2) and both dtypes: the bare kernel in each of
    its two stagings (shared memory where a block fits), timed in turns
    (shared, device, device, shared), the waves the shared blocks need
    (B over ``rts_shared_rows``), the staging the rule picks, and the two
    held against each other to the bit.  The readings ``RTS_SHARED_WAVES``
    is set from.  The wrapper always takes the rule's staging, so the sweep
    forces each by replacing ``rts_geometry`` for the call."""
    from unittest import mock
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    out = []
    sms = ck._sm_count(0)
    for dt in (torch.float32, torch.float64):
        conv_tol = max(1e-8, 50.0 * float(torch.finfo(dt).eps))
        for m in (1, 2, 3, 4):
            model = main_path_model(bt, dt) if m == 2 \
                else sweep_model(bt, "poisson", m, dt, n=153)
            for B in (1024, 4096, 16384):
                spec = model.build(thetas_around_init(model, B, 59))
                g = amod.approximate(spec, conv_tol, 100).gaussian(spec)
                item = spec.y.element_size()
                rows = ck.rts_shared_rows(spec.n, m, item, sms)
                geo = {"shared": ck.RtsGeometry(
                    ck.RTS_ROWS_SHARED, True, ck.RTS_ROWS_SHARED * (
                        ck.rts_sys_elems(m) + ck.rts_row_elems(spec.n, m))
                    * item), "device": ck.RtsGeometry(
                    ck.RTS_ROWS_DEVICE, False,
                    ck.RTS_ROWS_DEVICE * ck.rts_sys_elems(m) * item)}
                r = {"dtype": str(dt).replace("torch.", ""), "m": m, "B": B,
                     "waves_shared": B / rows if rows else None,
                     "picked": "shared" if ck.rts_geometry(
                         spec.n, m, item, B, sms).shared else "device"}
                names = ("shared", "device", "device", "shared") if rows \
                    else ("device", "device")
                got = {}
                for name in names:
                    with mock.patch.object(ck, "rts_geometry",
                                           lambda *_, x=geo[name]: x):
                        got[name] = ck.rts_factors(g)
                        r.setdefault(name + "_ms", []).append(bare_ms(
                            lambda: ck.rts_factors(g), "bssm_rts_factors"))
                torch.cuda.synchronize()
                if rows:
                    r["faster"] = min(("shared", "device"),
                                      key=lambda k: min(r[k + "_ms"]))
                    r["bit_equal"] = all(torch.equal(a, b) for a, b in zip(
                        got["shared"], got["device"]))
                    if not r["bit_equal"]:
                        FAILURES.append({"what": "rts_factors: the two "
                                                 "stagings differ",
                                         "dtype": r["dtype"], "m": m,
                                         "B": B})
                out.append(r)
                del got, g, spec
                torch.cuda.empty_cache()
    return out


FS_SWEEP_B = (1024, 4096, 16384, 65536)


def fs_staging_sweep(bt) -> list:
    """``fast_smoother_ll`` at n = 153 over B in ``FS_SWEEP_B``, m = 1..4
    (the airquality ``bsm_lg`` at m = 2, the sweep models else) and both
    dtypes: the bare kernel under each layout of ``fs_options`` (the whole
    series in shared memory where its blocks fit, tiles with checkpoints),
    timed in turns (shared, checkpoint, checkpoint, shared), the waves of
    the shared layout's blocks, the layout the rule picks, and the two
    against each other to the bit (a failure otherwise).  The readings
    ``FS_SHARED_WAVES`` is set from."""
    from bssm_tpu_torch.ops import cuda_kalman as ck
    out = []
    sms = ck._sm_count(0)
    for dt in (torch.float32, torch.float64):
        for m in (1, 2, 3, 4):
            model = airquality_model(bt, dt) if m == 2 \
                else lg_sweep_model(bt, m, dt, n=153)
            for B in FS_SWEEP_B:
                spec = model.build(thetas_around_init(model, B, 67,
                                                      spread=0.3))
                item = spec.y.element_size()
                opts = {k: g for k, g in ck.fs_options(spec.n, m, item)
                        .items() if g is not None}
                r = {"dtype": str(dt).replace("torch.", ""), "m": m, "B": B,
                     "waves_shared": (ck.fs_waves(opts["shared"], B, sms)
                                      if "shared" in opts else None),
                     "chunk_tiled": opts["checkpoint"].chunk,
                     "picked": [k for k, g in opts.items() if g ==
                                ck.fs_geometry(spec.n, m, item, B, sms)][0],
                     "bare_ms": {}}
                got = {}
                for name in list(opts) + list(reversed(list(opts))):
                    geo = opts[name]
                    if name not in got:
                        got[name] = ck.fast_smoother_ll(spec, staging=geo)
                    r["bare_ms"].setdefault(name, []).append(bare_ms(
                        lambda: ck.fast_smoother_ll(spec, staging=geo),
                        "bssm_fast_smoother_ll"))
                torch.cuda.synchronize()
                r["faster"] = min(r["bare_ms"],
                                  key=lambda k: min(r["bare_ms"][k]))
                first = got[r["picked"]]
                r["bit_equal"] = all(
                    torch.equal(first[0], g[0]) and torch.equal(first[1],
                                                                g[1])
                    for g in got.values())
                if not r["bit_equal"]:
                    FAILURES.append({"what": "fast_smoother_ll: the "
                                             "stagings differ",
                                     "dtype": r["dtype"], "m": m, "B": B})
                out.append(r)
                del got, spec
                torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the linear-Gaussian kernels against their plain versions
# ---------------------------------------------------------------------------

def compare_lg(name: str, got: torch.Tensor, ref: torch.Tensor,
               atol, rtol: float) -> dict:
    """Every entry inside atol + rtol |ref| (``atol`` may be per entry);
    -inf, +inf and NaN in the same places."""
    got, ref = got.double(), ref.double()
    same = bool((torch.isnan(got) == torch.isnan(ref)).all()
                and (torch.isinf(got) == torch.isinf(ref)).all()
                and (got[torch.isinf(got)] == ref[torch.isinf(ref)]).all())
    fin = torch.isfinite(got) & torch.isfinite(ref)
    diff = torch.where(fin, (got - ref).abs(), torch.zeros_like(ref))
    lim = atol + rtol * torch.where(fin, ref.abs(), torch.zeros_like(ref))
    ok = same and bool((diff <= lim).all())
    res = {"what": name, "max_abs_err": float(diff.max()),
           "max_err_over_tol": float((diff / lim).max()),
           "infinite_rows": int((~fin).sum()), "ok": ok}
    if not ok:
        FAILURES.append(res)
    return res


def check_lg(model, B: int, label: str, timed: bool, degenerate_rows: int = 0,
             seed: int = 29) -> dict:
    """The Kalman log-likelihood and fast-smoother kernels against their
    plain versions on the same spec on the card.  ``degenerate_rows`` rows
    get sds of 1e-6 (the kernel wrapper's degenerate rule makes them -inf on
    both sides)."""
    from bssm_tpu_torch.ops import cuda_kalman as ck
    from bssm_tpu_torch.ops import kalman
    dt = model.dtype
    f64 = dt == torch.float64
    th = thetas_around_init(model, B, seed, spread=0.3)
    if degenerate_rows:
        is_log = torch.as_tensor(model.transforms == 1,  # log-sampled
                                 device="cuda")
        th[:degenerate_rows] = torch.where(
            is_log, torch.full_like(th[0], float(np.log(1e-6))),
            th[:degenerate_rows])
    spec = model.build(th)
    out = {"label": label, "B": B, "n": spec.n, "m": spec.m,
           "dtype": str(dt).replace("torch.", ""), "checks": []}
    rule = kalman.degenerate_h2rr
    k_ll = ck.log_likelihood(spec)
    p_ll = kalman.log_likelihood(spec, degenerate=rule)
    k_a, k_l = ck.fast_smoother_ll(spec)
    p_a, p_l = kalman.fast_smoother_ll(spec, degenerate=rule)
    torch.cuda.synchronize()
    row_scale = p_a.double().abs().flatten(1).max(1).values[:, None, None]
    if f64:
        tols = {"ll": (F64_TOL, F64_TOL), "alpha": (F64_TOL, F64_TOL)}
    else:
        tols = {"ll": (1e-5, 2e-5), "alpha": (3e-4 * (1.0 + row_scale), 0.0)}
    # a degenerate row's means divide by innovation variances near 1e-12:
    # its log-likelihood is -inf on both sides, its means are not compared
    keep = slice(degenerate_rows, None)
    if not f64:
        tols["alpha"] = (tols["alpha"][0][keep], 0.0)
    out["checks"] += [
        compare_lg("log_likelihood", k_ll, p_ll, *tols["ll"]),
        compare_lg("fast_smoother_ll.ll", k_l, p_l, *tols["ll"]),
        compare_lg("fast_smoother_ll.alpha", k_a[keep], p_a[keep],
                   *tols["alpha"])]
    if int(torch.isneginf(p_ll).sum()) != degenerate_rows:
        FAILURES.append({"what": "degenerate rows", "label": label,
                         "got": int(torch.isneginf(p_ll).sum())})
    # every staging of the smoother gives the rule's bits
    item = spec.y.element_size()
    out["fs_geometry"] = ck.fs_geometry(spec.n, spec.m, item, B,
                                        ck._sm_count(0))._asdict()
    out["fs_stagings_bit_equal"] = True
    for name, geo in ck.fs_options(spec.n, spec.m, item).items():
        if geo is None:
            continue
        a2, l2 = ck.fast_smoother_ll(spec, staging=geo)
        torch.cuda.synchronize()
        if not (torch.equal(a2, k_a) and torch.equal(l2, k_l)):
            out["fs_stagings_bit_equal"] = False
            FAILURES.append({"what": f"fast_smoother_ll: staging {name} "
                                     "differs from the rule's",
                             "label": label})
    if timed:
        out["ms"] = {"log_likelihood": time_ms(lambda: ck.log_likelihood(spec)),
                     "fast_smoother_ll": time_ms(
                         lambda: ck.fast_smoother_ll(spec))}
        out["plain_ms"] = {
            "log_likelihood": time_ms(lambda: kalman.log_likelihood(
                spec, degenerate=rule), reps=1, warmup=0),
            "fast_smoother_ll": time_ms(lambda: kalman.fast_smoother_ll(
                spec, degenerate=rule), reps=1, warmup=0)}
        out["bounds"] = lg_bounds(spec, B, dt)
        out["bare_ms"] = {
            "log_likelihood": bare_ms(lambda: ck.log_likelihood(spec),
                                      "bssm_kalman_ll"),
            "fast_smoother_ll": bare_ms(lambda: ck.fast_smoother_ll(spec),
                                        "bssm_fast_smoother_ll")}
        out["one_kernel"] = one_kernel(lambda: ck.log_likelihood(spec),
                                       "log_likelihood")
        out["one_kernel_smoother"] = one_kernel(
            lambda: ck.fast_smoother_ll(spec), "fast_smoother_ll")
    D = spec.D if spec.D.dim() == 2 else spec.D[None]
    if D.shape[0] > 1 and D.shape[1] > 1:
        out["D_tile"] = dict(zip(("chunk", "smem_bytes"), ck.kalman_tile(
            spec.n, spec.y.element_size())))
    return out


def read_elems(x: torch.Tensor) -> int:
    """Elements a kernel reads of ``x`` once each: those along its axes of
    nonzero stride (a stride-0 axis is one value repeated)."""
    return int(np.prod([s for s, st in zip(x.shape, x.stride()) if st]))


def lg_bounds(spec, B: int, dt) -> dict:
    """Least time of the two linear-Gaussian kernels on this spec: bytes of
    the y, H and D series the kernels read (a leaf with batch stride 0,
    shared by every row, once; a batched one B times), the packed system and
    the outputs; operations B n kf_step_ops(m), plus B n bwd_mean_ops(m) for
    the smoother."""
    it = torch.finfo(dt).bits // 8
    n, m = spec.n, spec.m
    series = sum(read_elems(x) for x in (spec.y, spec.H, spec.D))
    inputs = series + (3 * m + 3 * m * m) * B
    kf = B * n * kf_step_ops(m)
    return {"log_likelihood": roofline(it * (inputs + B), kf),
            "fast_smoother_ll": roofline(
                it * (inputs + B + B * (n + 1) * m),
                kf + B * n * bwd_mean_ops(m))}


# ---------------------------------------------------------------------------
# the large-ensemble kernel against its plain versions
# ---------------------------------------------------------------------------

def compare_rows(name: str, got: torch.Tensor, ref: torch.Tensor,
                 atol: torch.Tensor, cap: torch.Tensor,
                 min_share: float) -> dict:
    """Per-row |got - ref| against the per-row tolerance ``atol``: at least
    ``min_share`` of the rows inside it, every row inside ``cap``, both
    finite everywhere, and the mean difference (in units of ``cap``) within
    5 standard errors plus the mean tight tolerance of zero.  The share
    outside ``atol`` is reported as flipped."""
    got, ref = got.double(), ref.double()
    finite = bool(torch.isfinite(got).all() and torch.isfinite(ref).all())
    diff = (got - ref).abs()
    inside = float((diff <= atol).double().mean())
    rel = (got - ref) / cap
    se = float(rel.std()) / np.sqrt(rel.numel()) if rel.numel() > 1 else 0.0
    bias_ok = bool(abs(float(rel.mean()))
                   <= 5.0 * se + float((atol / cap).mean()))
    ok = bool(finite and inside >= min_share
              and bool((diff <= cap).all()) and bias_ok)
    res = {"what": name, "max_abs_err": float(diff.max()),
           "share_flipped": 1.0 - inside, "min_share": min_share,
           "mean_diff_over_cap": float(rel.mean()), "mean_diff_se": se,
           "ok": ok}
    if not ok:
        FAILURES.append(res)
    return res


def big_inputs(model, B: int, seed: int, spread: float = 0.5):
    """Spec, approximation and proposal factors of B rows ``spread`` around
    the initial theta, through the K1 and K2 kernels."""
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.inference.mcmc import _psi_al
    from bssm_tpu_torch.ops import cuda_kalman as ck
    spec = model.build(thetas_around_init(model, B, seed, spread))
    al = _psi_al(spec, amod.approximate(spec))
    fac = ck.rts_factors(al.approx.gaussian(spec))
    return spec, al, fac


PSI_CAP = 0.35                   # largest |kernel - plain| of a psi row
FLIP_RATE = {"psi": 0.3, "bsf": 0.5}   # c of the docstring's lambda


def compare_big(name: str, got, ref, dt, resamplings: int, N: int,
                scales=None) -> dict:
    """The stated tolerance of one mode: ``scales`` given means psi mode;
    ``resamplings`` is the number of resampling steps of a row."""
    r = ref.double().abs()
    if dt == torch.float64:
        tol = F64_TOL * (1.0 + r)
        return compare_rows(name, got, ref, tol, tol, 1.0)
    c = FLIP_RATE["bsf" if scales is None else "psi"]
    p = float(np.exp(-c * resamplings * N * N * 2.0 ** -23))
    min_share = p - 0.02 - 4.0 * float(np.sqrt(p * (1.0 - p) / r.numel()))
    if scales is not None:
        atol = 2e-4 + 2e-6 * scales.double().abs().sum(-1)
        return compare_rows(name, got, ref, atol,
                            torch.full_like(r, PSI_CAP), min_share)
    return compare_rows(name, got, ref, 2e-4 * (1.0 + r), 0.5 + 0.05 * r,
                        min_share)


def check_big(model, B: int, N: int, kk: int, label: str, timed: bool,
              modes=("psi", "bsf"), seed: int = 11,
              spread: float = 0.5) -> dict:
    """The modes of the large-ensemble kernel, stream randomness, against
    their plain versions on the same tensors on the card."""
    from bssm_tpu_torch.inference import particle as pmod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    dt, m = model.dtype, model.extra["m"]
    spec, al, fac = big_inputs(model, B, seed, spread)
    n = spec.n
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    eps = torch.randn((B, n + 1, N, m), dtype=dt, device="cuda",
                      generator=gen)
    us = torch.rand((B, n, N), dtype=dt, device="cuda", generator=gen)
    eps_b, us_b = eps[:, :n].contiguous(), us[:, :n - 1].contiguous()
    geo = {mode: ck.big_geometry(N, m, spec.y.element_size(), mode == "bsf")
           for mode in ("psi", "bsf")}
    out = {"label": label, "B": B, "n": n, "m": m, "N": N, "kk": kk,
           "dtype": str(dt).replace("torch.", ""),
           "family": spec.distribution, "checks": [], "ms": {},
           "plain_ms": {}, "geometry": {k: g._asdict() for k, g in geo.items()
                                        if k in modes}}
    calls = {
        "psi": ("psi_big_logw", -(-n // kk), al.scales,
                lambda: ck.psi_big_logw(spec, al, *fac, kk, eps=eps, us=us),
                lambda: pmod.psi_logw_scan(spec, al, eps, us, factors=fac,
                                           resample_every=kk)),
        "bsf": ("bsf_big_logw", -(-(n - 1) // kk), None,
                lambda: ck.bsf_big_logw(spec, kk, eps=eps_b, us=us_b),
                lambda: pmod.bsf_logw_scan(spec, eps_b, us_b,
                                           resample_every=kk))}
    for mode in modes:
        name, resamplings, scales, kernel, plain = calls[mode]
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        out["checks"].append(compare_big(name, got, ref, dt, resamplings, N,
                                         scales))
        if timed:
            out["ms"][name] = time_ms(kernel)
            out["plain_ms"][name] = time_ms(plain, reps=1, warmup=0)
    return out


def check_philox(model, B: int, N: int, kk: int, label: str,
                 seed: int = 13, plain=("psi", "bsf")) -> dict:
    """``philox_fill`` against its plain version and its moments, then the
    kernel's Philox mode against its stream mode and, for the modes in
    ``plain``, against the plain version on the filled tensors (the main
    model's diffuse initial state puts float32 bootstrap rows in the far
    tail, so its bootstrap mode is held against the stream mode only)."""
    from bssm_tpu_torch.inference import particle as pmod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    dt, m = model.dtype, model.extra["m"]
    f64 = dt == torch.float64
    spec, al, fac = big_inputs(model, B, seed)
    n = spec.n
    gen = torch.Generator(device="cuda").manual_seed(seed)
    key, key2 = ck.philox_key(gen, "cuda"), ck.philox_key(gen, "cuda")
    eps, us = ck.philox_fill(key, B, n + 1, N, m, dt)
    p_eps, p_us = ck.philox_fill_plain(key, B, n + 1, N, m, dt)
    eps2, _ = ck.philox_fill(key2, B, n + 1, N, m, dt)
    out = {"label": label, "B": B, "n": n, "m": m, "N": N, "kk": kk,
           "dtype": str(dt).replace("torch.", ""), "checks": []}
    out["checks"].append(compare("philox_fill.us", us, p_us,
                                 1e-15 if f64 else 1e-7, True))
    # cos / sin of 2 pi u against sincospi(2 u): roundoff of the angle
    out["checks"].append(compare("philox_fill.eps", eps, p_eps,
                                 1e-12 if f64 else 2e-5, True))
    e, u = eps.double(), us.double()
    mom = {"eps_mean": float(e.mean()), "eps_var": float(e.var()),
           "eps_abs_max": float(e.abs().max()), "us_mean": float(u.mean()),
           "us_min": float(u.min()), "us_max": float(u.max()),
           "count_eps": e.numel(), "count_us": u.numel(),
           "other_key_equal_share": float((eps == eps2).double().mean())}
    se = 1.0 / np.sqrt(e.numel())
    mom["ok"] = bool(abs(mom["eps_mean"]) < 5 * se
                     and abs(mom["eps_var"] - 1.0) < 5 * np.sqrt(2.0) * se
                     and abs(mom["us_mean"] - 0.5)
                     < 5 / np.sqrt(12.0 * u.numel())
                     and 0.0 < mom["us_min"] and mom["us_max"] < 1.0
                     and mom["other_key_equal_share"] < 1e-3)
    out["moments"] = mom
    if not mom["ok"]:
        FAILURES.append({"what": "philox_fill moments", **mom})
    tol = 1e-12 if f64 else 1e-6
    eps_b, us_b = eps[:, :n].contiguous(), us[:, :n - 1].contiguous()
    for mode, name, a, b, scan, resamplings, scales in (
            ("psi", "psi_big_logw",
             ck.psi_big_logw(spec, al, *fac, kk, seed=key, nsim=N),
             ck.psi_big_logw(spec, al, *fac, kk, eps=eps, us=us),
             lambda: pmod.psi_logw_scan(spec, al, eps, us, factors=fac,
                                        resample_every=kk),
             -(-n // kk), al.scales),
            ("bsf", "bsf_big_logw",
             ck.bsf_big_logw(spec, kk, seed=key, nsim=N),
             ck.bsf_big_logw(spec, kk, eps=eps_b, us=us_b),
             lambda: pmod.bsf_logw_scan(spec, eps_b, us_b,
                                        resample_every=kk),
             -(-(n - 1) // kk), None)):
        torch.cuda.synchronize()
        out["checks"].append(compare(f"{name} philox vs stream", a, b, tol,
                                     True))
        if mode in plain:
            out["checks"].append(compare_big(
                f"{name} philox vs plain", a, scan(), dt, resamplings, N,
                scales))
    return out


def check_anc(model, B: int, N: int, kk: int, mode: str, label: str,
              seed: int = 15, spread: float = 0.5) -> dict:
    """Float32 check of the large-ensemble kernel that holds every row: the
    plain version runs with its own search and returns the ancestors it
    chose; the kernel is fed those ancestors (``anc``, stream mode) on the
    same tensors, so that no near-tie can flip a resampled ancestor, and
    every row must agree at the tight tolerance of ``compare_big`` (psi:
    2e-4 + 2e-6 sum|scales|, bsf: 2e-4 (1 + |ref|)).  The plain version,
    fed its own ancestors, must give its own result to the bit."""
    from bssm_tpu_torch.inference import particle as pmod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    dt, m = model.dtype, model.extra["m"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    if mode == "psi":
        spec, al, fac = big_inputs(model, B, seed, spread)
        n = spec.n
        eps = torch.randn((B, n + 1, N, m), dtype=dt, device="cuda",
                          generator=gen)
        us = torch.rand((B, n, N), dtype=dt, device="cuda", generator=gen)
        ref, anc = pmod.psi_logw_scan(spec, al, eps, us, factors=fac,
                                      resample_every=kk,
                                      return_ancestors=True)
        again = pmod.psi_logw_scan(spec, al, eps, us, factors=fac,
                                   resample_every=kk, anc=anc)
        geo = ck.big_geometry(N, m, spec.y.element_size(), False)
        got = ck.psi_big_logw(spec, al, *fac, kk, eps=eps, us=us, anc=anc)
        atol = 2e-4 + 2e-6 * al.scales.double().abs().sum(-1)
        name = "psi_big_logw"
    else:
        spec = model.build(thetas_around_init(model, B, seed))
        n = spec.n
        eps = torch.randn((B, n, N, m), dtype=dt, device="cuda",
                          generator=gen)
        us = torch.rand((B, n - 1, N), dtype=dt, device="cuda",
                        generator=gen)
        ref, anc = pmod.bsf_logw_scan(spec, eps, us, resample_every=kk,
                                      return_ancestors=True)
        again = pmod.bsf_logw_scan(spec, eps, us, resample_every=kk, anc=anc)
        geo = ck.big_geometry(N, m, spec.y.element_size(), True)
        got = ck.bsf_big_logw(spec, kk, eps=eps, us=us, anc=anc)
        atol = 2e-4 * (1.0 + ref.double().abs())
        name = "bsf_big_logw"
    torch.cuda.synchronize()
    out = {"label": label, "B": B, "n": n, "m": m, "N": N, "kk": kk,
           "dtype": str(dt).replace("torch.", ""), "geometry": geo._asdict(),
           "checks": [compare_rows(f"{name} injected ancestors", got, ref,
                                   atol, atol, 1.0)],
           "plain_own_ancestors_bit_equal": bool(torch.equal(again, ref))}
    if not out["plain_own_ancestors_bit_equal"]:
        FAILURES.append({"what": f"{name}: plain version fed its own "
                                 "ancestors differs", "label": label})
    return out


def time_big(psi_model, bsf_model, B: int, N_psi: int, kk_psi: int,
             N_bsf: int, B_bsf: int, N_da: int, B_da: int) -> dict:
    """Times of both modes at the shapes the paths give them, Philox mode
    (psi mode also at the delayed-acceptance path's B_da rows and N_da
    particles, period 1), the bare kernel's device time, and the times of
    stream mode and the plain versions on the tensors ``philox_fill`` wrote
    for the same key; the comparison at this width rides along."""
    from bssm_tpu_torch.inference import particle as pmod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    res = {}
    gen = torch.Generator(device="cuda").manual_seed(17)
    key = ck.philox_key(gen, "cuda")
    # psi mode --------------------------------------------------------------
    spec, al, fac = big_inputs(psi_model, B, 19)
    n, m, dt = spec.n, psi_model.extra["m"], psi_model.dtype
    r = {"shape": f"B={B} n={n} m={m} N={N_psi} kk={kk_psi} float32"}
    r["ms"] = time_ms(lambda: ck.psi_big_logw(
        spec, al, *fac, kk_psi, seed=key, nsim=N_psi))
    r["ms_kk1"] = time_ms(lambda: ck.psi_big_logw(
        spec, al, *fac, 1, seed=key, nsim=N_psi))
    eps, us = ck.philox_fill(key, B, n + 1, N_psi, m, dt)
    r["ms_stream"] = time_ms(lambda: ck.psi_big_logw(
        spec, al, *fac, kk_psi, eps=eps, us=us))
    r["plain_ms"] = time_ms(lambda: pmod.psi_logw_scan(
        spec, al, eps, us, factors=fac, resample_every=kk_psi),
        reps=1, warmup=0)
    got = ck.psi_big_logw(spec, al, *fac, kk_psi, seed=key, nsim=N_psi)
    ref = pmod.psi_logw_scan(spec, al, eps, us, factors=fac,
                             resample_every=kk_psi)
    torch.cuda.synchronize()
    r["check"] = compare_big(f"psi_big_logw philox vs plain B={B}", got, ref,
                             dt, -(-n // kk_psi), N_psi, al.scales)
    r.update(big_bounds(B, n, n, m, N_psi, kk_psi, dt, psi=True))
    r["bare_ms"] = bare_ms(lambda: ck.psi_big_logw(
        spec, al, *fac, kk_psi, seed=key, nsim=N_psi), "bssm_particle_big",
        reps=3)
    del eps, us, got, ref
    torch.cuda.empty_cache()
    # the delayed-acceptance path's launches: B_da rows, N_da, period 1
    spec, al, fac = big_inputs(psi_model, B_da, 19)
    tag = f"_B{B_da}_N{N_da}_kk1"
    r["ms" + tag] = time_ms(lambda: ck.psi_big_logw(
        spec, al, *fac, 1, seed=key, nsim=N_da))
    r["bare_ms" + tag] = bare_ms(lambda: ck.psi_big_logw(
        spec, al, *fac, 1, seed=key, nsim=N_da), "bssm_particle_big")
    eps, us = ck.philox_fill(key, B_da, n + 1, N_da, m, dt)
    r["plain_ms" + tag] = time_ms(lambda: pmod.psi_logw_scan(
        spec, al, eps, us, factors=fac, resample_every=1), reps=1, warmup=0)
    r["bound_ms" + tag] = big_bounds(B_da, n, n, m, N_da, 1, dt,
                                     psi=True)["bound_ms"]
    res["psi_big_logw"] = r
    del eps, us
    torch.cuda.empty_cache()
    # bootstrap mode ----------------------------------------------------------
    m = bsf_model.extra["m"]
    dt = bsf_model.dtype
    r = {}
    for rows, tag in ((B_bsf, ""), (B, f"_B{B}")):
        spec = bsf_model.build(thetas_around_init(bsf_model, rows, 23))
        n = spec.n
        r["ms" + tag] = time_ms(lambda: ck.bsf_big_logw(
            spec, 1, seed=key, nsim=N_bsf))
        r["bare_ms" + tag] = bare_ms(lambda: ck.bsf_big_logw(
            spec, 1, seed=key, nsim=N_bsf), "bssm_particle_big", reps=3)
        eps, us = ck.philox_fill(key, rows, n, N_bsf, m, dt)
        r["ms_stream" + tag] = time_ms(lambda: ck.bsf_big_logw(
            spec, 1, eps=eps, us=us))
        r["plain_ms" + tag] = time_ms(lambda: pmod.bsf_logw_scan(
            spec, eps, us, resample_every=1), reps=1, warmup=0)
        if not tag:
            got = ck.bsf_big_logw(spec, 1, seed=key, nsim=N_bsf)
            ref = pmod.bsf_logw_scan(spec, eps, us, resample_every=1)
            torch.cuda.synchronize()
            r["check"] = compare_big(
                f"bsf_big_logw philox vs plain B={rows}", got, ref, dt,
                n - 1, N_bsf)
            r["shape"] = f"B={rows} n={n} m={m} N={N_bsf} kk=1 float32"
            r.update(big_bounds(rows, n, n - 1, m, N_bsf, 1, dt, psi=False))
        else:
            r["bound_ms" + tag] = big_bounds(rows, n, n - 1, m, N_bsf, 1, dt,
                                             psi=False)["bound_ms"]
        del eps, us
        torch.cuda.empty_cache()
    res["bsf_big_logw"] = r
    return res


def big_bounds(B: int, n: int, S: int, m: int, N: int, kk: int, dt,
               psi: bool) -> dict:
    """Least time for one launch of the large-ensemble kernel in Philox mode
    on these shapes.  Bytes: the observation and factor rows read once, one
    scalar written.  Operations per particle and step, counted from
    csrc/particle_big.cu (integer operations of the generator at the
    float32 rate; a multiply-add is 2): Philox 10 rounds x 10 = 100 for the
    normals' call, whose third word also gives the resampling uniform at
    m <= 2, and at m > 2 another 100 at a resampling step for the uniform's
    call; 3 for each word turned into a uniform; 60 a Box-Muller pair (log,
    sqrt, sincospi); resampling step: exp 10, block scan 10 + warps, binary
    search 4 log2 N, gather m; propagation 4 m^2 + m; signal 2 m;
    log-weight 20; block max and sum with exp and log 70."""
    it = torch.finfo(dt).bits // 8
    mm = m * m
    pairs = (m + 1) // 2
    warps = (N + 31) // 32
    normals = 100 + 6 * pairs + 60 * pairs
    uniform = 3 if m <= 2 else 100 + 3
    resample = uniform + 10 + 10 + warps + 4 * int(np.ceil(np.log2(N))) + m
    step = normals + resample / kk + 4 * mm + m + 2 * m + 20 + 70
    ops = B * (S + 1) * N * step
    if psi:
        byts = it * (3 * B * n + B * (n + 1) * (m + 2 * mm) + 3 * n
                     + B * (m + 1) + B) + 16
    else:
        byts = it * (B * (2 * m + 3 * mm) + 3 * n + B * (m + 1) + B) + 16
    t_b = byts / PEAK_BYTES_PER_S * 1e3
    t_o = ops / PEAK_F32_FLOPS * 1e3
    return {"bytes": byts, "operations": ops,
            "operations_per_particle_step": step,
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def big_section(bt, m32, m64):
    """The large-ensemble kernel's checks and times (step 4 of the module
    docstring); emits the ``big_checks`` line.  Returns ``(every run, the
    runs at the paths' shapes, time_big's readings)``."""
    big = []
    big_main = []
    mb32, mb64 = calm_model(bt, torch.float32), calm_model(bt, torch.float64)
    for psi_model, bsf_model in ((m32, mb32), (m64, mb64)):
        for N in (256, 200):
            for kk in (1, 8):
                big_main.append(check_big(
                    psi_model, 2048, N, kk, f"main psi N={N} kk={kk}",
                    timed=True, modes=("psi",)))
                big_main.append(check_big(
                    bsf_model, 2048, N, kk, f"main bsf N={N} kk={kk}",
                    timed=True, modes=("bsf",)))
        # the delayed-acceptance path's shape
        big_main.append(check_big(psi_model, 1024, 64, 1,
                                  "main psi N=64 kk=1 B=1024", timed=True,
                                  modes=("psi",)))
    big += big_main
    # the sweeps start the bootstrap filter from a proper initial variance:
    # under the diffuse one some rows sit in the far tail, where a float32
    # estimate is of the order 1e13 and so is the effect of a flip
    for dtype in (torch.float64, torch.float32):
        def sweep(label, B, N, kk, *a, **kw):
            big.append(check_big(sweep_model(bt, *a, dtype, p1=1.0, **kw),
                                 B, N, kk, label, timed=False))
        for fam in ("svm", "binomial", "negative binomial", "gamma"):
            sweep(f"sweep {fam} (2 missing y)", 256, 40, 2, fam, 2)
        for m in (1, 3, 4):
            sweep(f"sweep m={m}", 256, 40, 3, "poisson", m)
        for N, kk in ((33, 1), (512, 1), (512, 5)):
            sweep(f"sweep N={N}", 256, N, kk, "poisson", 2)
        # a block of 32 threads is narrower than the step's 42 scalars
        for N in (2, 32):
            sweep(f"sweep m=4 N={N}", 256, N, 1, "poisson", 4)
        sweep("sweep gamma + xreg", 256, 64, 4, "gamma", 2, xreg=True)
    psi_only = dict(plain=("psi",))
    philox = [check_philox(m32, 512, 256, 8, "philox f32 N=256 kk=8",
                           **psi_only),
              check_philox(m32, 512, 200, 1, "philox f32 N=200 kk=1",
                           **psi_only),
              # the delayed-acceptance path's shape
              check_philox(m32, 1024, 64, 1, "philox f32 N=64 kk=1 B=1024",
                           **psi_only),
              check_philox(m64, 256, 256, 8, "philox f64 N=256 kk=8"),
              check_philox(m64, 256, 64, 1, "philox f64 N=64 kk=1"),
              check_philox(sweep_model(bt, "poisson", 4, torch.float32,
                                       p1=1.0), 256, 40, 3, "philox f32 m=4"),
              check_philox(sweep_model(bt, "poisson", 4, torch.float32,
                                       p1=1.0), 256, 32, 1,
                           "philox f32 m=4 N=32"),
              check_philox(sweep_model(bt, "poisson", 3, torch.float64,
                                       p1=1.0), 256, 33, 1, "philox f64 m=3")]
    # float32, every row: both sides fed the plain search's ancestors, at
    # the shapes of pm_bsf_N200, da_psi_N64 and psi_N256's correction
    anc = [check_anc(mb32, 1024, 200, 1, "bsf", "anc bsf N=200 kk=1 B=1024"),
           check_anc(m32, 1024, 64, 1, "psi", "anc psi N=64 kk=1 B=1024"),
           check_anc(m32, 16384, 256, 8, "psi",
                     "anc psi N=256 kk=8 B=16384")]
    # two warps a row, which the rule picks above N = 256, with a thread's
    # slots partly empty (N = 300) and full (N = 512): float32 every row
    # with injected ancestors, float64 every row
    anc += [check_anc(m32, 512, 300, 2, "psi", "anc psi N=300 kk=2"),
            check_anc(mb32, 512, 512, 1, "bsf", "anc bsf N=512 kk=1")]
    torch.cuda.empty_cache()
    two_warps = [check_big(m64, 256, 300, 3, "f64 N=300 kk=3", timed=False,
                           modes=("psi",)),
                 check_big(mb64, 256, 300, 3, "f64 bsf N=300 kk=3",
                           timed=False, modes=("bsf",))]
    t_big = time_big(m32, mb32, 16384, 256, 8, 200, 1024, 64, 1024)
    emit("big_checks", {"runs": big, "philox": philox, "ancestors": anc,
                        "two_warps": two_warps, "timed": t_big,
                        "failures": FAILURES})
    return big, big_main, t_big



# the SV checks move theta this little around the initial one: rho starts
# at 0.98 and must stay below 1 in every row
SV_SPREAD = 0.003


def sv_big_times(model, B: int, N: int, kk: int) -> dict:
    """The large-ensemble kernel in psi mode at ``svm_is2_N64``'s
    correction chunk: Philox mode as the path runs it, the bare kernel,
    the plain version on the tensors ``philox_fill`` wrote, and the
    bound."""
    from bssm_tpu_torch.inference import particle as pmod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    spec, al, fac = big_inputs(model, B, 19, SV_SPREAD)
    n, m, dt = spec.n, model.extra["m"], model.dtype
    key = ck.philox_key(torch.Generator(device="cuda").manual_seed(17),
                        "cuda")

    def kernel():
        return ck.psi_big_logw(spec, al, *fac, kk, seed=key, nsim=N)

    r = {"shape": f"B={B} n={n} m={m} N={N} kk={kk} "
                  f"{str(dt).replace('torch.', '')}",
         "ms": time_ms(kernel), "bare_ms": bare_ms(kernel,
                                                   "bssm_particle_big",
                                                   reps=3)}
    eps, us = ck.philox_fill(key, B, n + 1, N, m, dt)
    r["plain_ms"] = time_ms(lambda: pmod.psi_logw_scan(
        spec, al, eps, us, factors=fac, resample_every=kk), reps=1, warmup=0)
    r.update(big_bounds(B, n, n, m, N, kk, dt, psi=True))
    del eps, us
    torch.cuda.empty_cache()
    return r


def sv_checks(bt) -> dict:
    """The kernels at shapes the kernel checks above never gave them:
    - ``svm_is2_N64``'s (the SV family at n = 945, m = 1, T, R, P1 and phi
      per row): K1, K2 and K3 at the correction's 8192-row chunks (timed)
      and K1 at phase 1's 2048 rows in float32, K1-K3 at 256 rows in
      float64, also for the "mu" type (a1 and C per row); K4 (N = 64,
      period 4) in float32 fed the plain version's ancestors (every row)
      at 2048 rows, in float64 against the plain version at 256, and timed
      at 8192;
    - per-row T, R, a1, P1 and C in K1-K3: ``ar1_ng`` negative binomial on
      the main path's series at the 1024 rows of ``ar1_ng_negbin_pm_N10``,
      both dtypes;
    with the stagings of K1 and K2 the rules pick at those shapes."""
    from bssm_tpu_torch.ops import cuda_kalman as ck
    sv32, sv64 = svm_model(bt, torch.float32), svm_model(bt, torch.float64)
    sv_mu = svm_model(bt, torch.float64,
                      mu=bt.normal_prior(-1.0, 0.0, 2.0))
    ar32 = ar1_negbin_model(bt, torch.float32)
    ar64 = ar1_negbin_model(bt, torch.float64)
    sp = dict(spread=SV_SPREAD)
    runs = [check_kernels(sv32, 8192, 10, "svm f32 B=8192 n=945",
                          timed=True, **sp),
            check_kernels(sv32, 2048, 10, "svm f32 B=2048 n=945",
                          timed=False, k1_only=True, **sp),
            check_kernels(sv64, 256, 10, "svm f64 B=256 n=945",
                          timed=False, **sp),
            check_kernels(sv_mu, 256, 10, "svm mu f64 B=256 n=945",
                          timed=False, **sp),
            check_kernels(ar32, 1024, 10, "ar1_ng negbin f32 B=1024",
                          timed=False, spread=0.03),
            check_kernels(ar64, 1024, 10, "ar1_ng negbin f64 B=1024",
                          timed=False, spread=0.03)]
    sms = ck._sm_count(0)
    for r in runs:
        r["rts_geometry"] = ck.rts_geometry(
            r["n"], r["m"], 4 if r["dtype"] == "float32" else 8, r["B"],
            sms)._asdict()
    big = [check_anc(sv32, 2048, 64, 4, "psi",
                     "anc svm psi N=64 kk=4 B=2048", **sp),
           check_big(sv64, 256, 64, 4, "svm f64 psi N=64 kk=4", timed=False,
                     modes=("psi",), **sp)]
    torch.cuda.empty_cache()
    return {"runs": runs, "big": big,
            "psi_big_times": sv_big_times(sv32, 8192, 64, 4)}


AB_SHAPES = (("K5 pm_bsf_N200", "bsf", 1024, 200, 1),
             ("K4 da_psi_N64", "psi", 1024, 64, 1),
             ("K4 psi_N256 chunk", "psi", 16384, 256, 8))


def big_ab_readings(bt) -> dict:
    """The readings of the large-ensemble kernel's A/B, on whichever package
    ``bt`` is (this one, or an earlier one with the same wrapper calls):
    wrapper and bare milliseconds in Philox mode at the three shapes of
    ``AB_SHAPES`` (float32, the paths' models), then the chain seconds of
    ``pm_bsf_N200`` and ``da_psi_N64`` and the phase-2 seconds of
    ``psi_N256`` and ``psi_N256_refexact`` as ``main`` runs them."""
    from bssm_tpu_torch.ops import cuda_kalman as ck
    m32 = main_path_model(bt, torch.float32)
    mb32 = calm_model(bt, torch.float32)
    key = ck.philox_key(torch.Generator(device="cuda").manual_seed(17),
                        "cuda")
    res = {"kernels": {}, "paths": {}}
    for label, mode, B, N, kk in AB_SHAPES:
        if mode == "psi":
            spec, al, fac = big_inputs(m32, B, 19)
            fn = lambda: ck.psi_big_logw(spec, al, *fac, kk,  # noqa: E731
                                         seed=key, nsim=N)
        else:
            spec = mb32.build(thetas_around_init(mb32, B, 23))
            fn = lambda: ck.bsf_big_logw(spec, kk, seed=key,  # noqa: E731
                                         nsim=N)
        res["kernels"][label] = {"ms": time_ms(fn, reps=20),
                                 "bare_ms": bare_ms(fn, "bssm_particle_big",
                                                    reps=20)}
        torch.cuda.empty_cache()
    is2 = dict(mcmc_type="is2", sampling_method="psi", store_modes=False,
               corr_batch=16384)
    for label, model, chains, iters, kw in (
            ("pm_bsf_N200", mb32, CHAINS // 4, 500,
             dict(particles=200, mcmc_type="pm", sampling_method="bsf")),
            ("da_psi_N64", m32, CHAINS // 4, 500,
             dict(particles=64, mcmc_type="da", sampling_method="psi")),
            ("psi_N256", m32, CHAINS, 1000,
             dict(particles=256, psi_resample_every=8, **is2)),
            ("psi_N256_refexact", m32, CHAINS // 4, 1000,
             dict(particles=256, psi_resample_every=1, **is2))):
        kw = dict(output_type="theta", seed=1, n_chains=chains, **kw)
        bt.run_mcmc(model, iter=20, **kw)                 # warm-up
        torch.cuda.synchronize()
        out = bt.run_mcmc(model, iter=iters, **kw)
        res["paths"][label] = {"chain_s": out.time["mcmc"],
                               "phase2_s": out.time.get("correction"),
                               "acceptance_rate": out.acceptance_rate}
        del out
        torch.cuda.empty_cache()
    return res


def geometry_sweep(bt) -> list:
    """Bare milliseconds of the large-ensemble kernel (Philox mode, float32)
    at the three shapes of ``AB_SHAPES`` under launch geometries the rule
    (``big_geometry``) does or does not pick: one warp a row against two,
    and at the bootstrap shape (N = 200, one warp) a thread's seven slots
    against eight.  Each pair is timed in turns (first, second, second,
    first) so that the pair's spread shows; under every geometry at least
    half the rows must agree with the rule's on the same key at
    ``compare_big``'s tight tolerance (another layout sums in another
    order, so float32 near-ties differ).  The readings the rule is chosen
    from; the wrappers always take the rule's geometry, so the sweep forces
    another by replacing ``big_geometry`` for the call."""
    from unittest import mock
    from bssm_tpu_torch.ops import cuda_kalman as ck
    m32 = main_path_model(bt, torch.float32)
    mb32 = calm_model(bt, torch.float32)
    key = ck.philox_key(torch.Generator(device="cuda").manual_seed(29),
                        "cuda")
    out = []
    for label, mode, B, N, kk in AB_SHAPES:
        bsf = mode == "bsf"
        model = mb32 if bsf else m32
        m = model.extra["m"]
        if bsf:
            spec = model.build(thetas_around_init(model, B, 23))
            call = lambda: ck.bsf_big_logw(  # noqa: E731
                spec, kk, seed=key, nsim=N)
        else:
            spec, al, fac = big_inputs(model, B, 19)
            call = lambda: ck.psi_big_logw(  # noqa: E731
                spec, al, *fac, kk, seed=key, nsim=N)
        rule = ck.big_geometry(N, m, 4, bsf)
        row = ck.big_row_elems(N, m, bsf) * 4
        p2 = next(p for p in ck.big_pmax_choices(4, m) if p >= -(-N // 64))
        two = ck.BigGeometry(64, 1, p2, row)
        one = ck.BigGeometry(32, rule.rows_per_block, rule.pmax,
                             rule.smem_bytes) if rule.threads_per_row == 32 \
            else None
        pairs = [("1 warp", one, "2 warps", two)] if one else []
        if bsf and one and one.pmax < 8:
            pairs.append((f"P={one.pmax}", one, "P=8", one._replace(pmax=8)))
        ref = call()
        for na, ga, nb, gb in pairs:
            r = {"shape": label, "pair": [na, nb], "geometry":
                 [ga._asdict(), gb._asdict()], "picked": [ga == rule,
                                                          gb == rule],
                 "bare_ms": [[], []], "max_abs_err": [0.0, 0.0]}
            for i in (0, 1, 1, 0):
                geo = (ga, gb)[i]
                with mock.patch.object(ck, "big_geometry",
                                       lambda *_, g=geo: g):
                    got = call()
                    r["bare_ms"][i].append(
                        bare_ms(call, "bssm_particle_big", reps=20))
                err = float((got - ref).abs().max())
                r["max_abs_err"][i] = max(r["max_abs_err"][i], err)
                if float(((got - ref).abs() <= 2e-4 * (1 + ref.abs()))
                         .double().mean()) < 0.5:
                    FAILURES.append({"what": "geometry_sweep", "shape": label,
                                     "geometry": geo._asdict()})
            out.append(r)
        torch.cuda.empty_cache()
    return out


def k2k3_ab_readings(bt) -> dict:
    """The readings of K2's and K3's A/B, on whichever package ``bt`` is
    (this one, or an earlier one with the same wrapper calls): wrapper and
    bare milliseconds of ``rts_factors`` and ``psi_logw`` (N = 10) at the
    main path's model, float32, B = 1024, 4096 and 16384 (phase 2 gives
    them 16384-row chunks, ``da_psi_N64`` K2 1024 rows), the digests of
    their outputs on fixed inputs (``k2k3_digests``), then the phase-2
    seconds of ``psi_N10`` (three runs) and the chain seconds of
    ``da_psi_N64`` (two runs) as ``main`` runs them."""
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    m32 = main_path_model(bt, torch.float32)
    res = {"kernels": {}, "paths": {}}
    for B in (1024, 4096, 16384):
        spec = m32.build(thetas_around_init(m32, B, 7))
        ar = amod.approximate(spec, 50.0 * float(torch.finfo(
            torch.float32).eps), 100)
        g = ar.gaussian(spec)
        fac = ck.rts_factors(g)
        zero = torch.zeros(B, dtype=torch.float32, device="cuda")
        al = amod.ApproxLoglik(ar, amod.mode_scales(spec, ar), zero, zero)
        gen = torch.Generator(device="cuda").manual_seed(8)
        eps = torch.randn((B, spec.n + 1, 10, 2), device="cuda",
                          generator=gen)
        us = torch.rand((B, spec.n, 10), device="cuda", generator=gen)
        k2 = lambda: ck.rts_factors(g)                        # noqa: E731
        k3 = lambda: ck.psi_logw(spec, al, *fac, eps, us)     # noqa: E731
        for name, fn, entry in (("rts_factors", k2, "bssm_rts_factors"),
                                ("psi_logw", k3, "bssm_psi_logw")):
            res["kernels"][f"{name} B={B}"] = {
                "ms": time_ms(fn, reps=20),
                "bare_ms": bare_ms(fn, entry, reps=20)}
        del fac, eps, us, g, ar, spec
        torch.cuda.empty_cache()
    res["digests"] = k2k3_digests(bt)
    for label, chains, iters, reps, kw in (
            ("psi_N10", CHAINS, 1000, 3,
             dict(particles=10, mcmc_type="is2", sampling_method="psi",
                  store_modes=False, corr_batch=16384)),
            ("da_psi_N64", CHAINS // 4, 500, 2,
             dict(particles=64, mcmc_type="da", sampling_method="psi"))):
        kw = dict(output_type="theta", seed=1, n_chains=chains, **kw)
        bt.run_mcmc(m32, iter=20, **kw)                   # warm-up
        r = res["paths"][label] = {"chain_s": [], "phase2_s": []}
        for _ in range(reps):
            torch.cuda.synchronize()
            out = bt.run_mcmc(m32, iter=iters, **kw)
            w = out.flat_weights()
            r["chain_s"].append(out.time["mcmc"])
            r["phase2_s"].append(out.time.get("correction"))
            r["acceptance_rate"] = out.acceptance_rate
            r["ess_is_fraction"] = (bt.ess_is(w) / w.size
                                    if out.weights is not None else None)
            del out
            torch.cuda.empty_cache()
    return res


def k2k3_digests(bt) -> dict:
    """SHA-256 of the outputs of ``rts_factors`` (ahat, Lb, Ab) and
    ``psi_logw`` (N = 10) on fixed inputs: the main path's model at
    B = 1024 and 16384 in float32 and at 1024 in float64, and the sweep
    models at m = 1, 3, 4 in both dtypes at B = 256 (the approximation by
    ``laplace_solve``, the randomness from a seeded generator).  Equal
    digests on two packages mean outputs equal to the bit."""
    import hashlib
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    sha = lambda ts: hashlib.sha256(b"".join(            # noqa: E731
        t.contiguous().cpu().numpy().tobytes() for t in ts)).hexdigest()
    cases = [("main f32 B=1024", main_path_model(bt, torch.float32), 1024),
             ("main f32 B=16384", main_path_model(bt, torch.float32),
              16384),
             ("main f64 B=1024", main_path_model(bt, torch.float64), 1024)]
    for dt in (torch.float32, torch.float64):
        for m in (1, 3, 4):
            cases.append((f"m={m} {str(dt).replace('torch.', '')} B=256",
                          sweep_model(bt, "poisson", m, dt), 256))
    out = {}
    for label, model, B in cases:
        dt = model.dtype
        spec = model.build(thetas_around_init(model, B, 61))
        ar = amod.approximate(spec, max(1e-8, 50.0 * float(
            torch.finfo(dt).eps)), 100)
        fac = ck.rts_factors(ar.gaussian(spec))
        zero = torch.zeros(B, dtype=dt, device="cuda")
        al = amod.ApproxLoglik(ar, amod.mode_scales(spec, ar), zero, zero)
        gen = torch.Generator(device="cuda").manual_seed(62)
        eps = torch.randn((B, spec.n + 1, 10, spec.m), dtype=dt,
                          device="cuda", generator=gen)
        us = torch.rand((B, spec.n, 10), dtype=dt, device="cuda",
                        generator=gen)
        lw = ck.psi_logw(spec, al, *fac, eps, us)
        out[label] = {"rts_factors": sha(fac), "psi_logw": sha([lw])}
    return out


def k7k8_ab_readings(bt) -> dict:
    """The readings of K7's and K8's A/B, on whichever package ``bt`` is
    (the wrapper calls are the same in both): wrapper and bare milliseconds
    of ``fast_smoother_ll`` on the airquality ``bsm_lg``, float32, at
    B = 1024, 4096, 16384 and 65536 (the paths give it 65536-row chunks),
    and of ``laplace_step`` on the main path's model at B = 1 (one model,
    as the single-model solve gives it), 4096 and 16384, each bare reading
    the median of five; the digests of both kernels' outputs on fixed
    inputs (``k7k8_digests``); the single-model solve's milliseconds
    (``ng_api``'s ``single_solve_ms``, three readings); and the states
    seconds of ``lg_full`` and ``approx_full`` (two runs each, as ``main``
    runs them)."""
    from bssm_tpu_torch.core.spec import drop_batch
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.inference.filters import spec_of
    from bssm_tpu_torch.ops import cuda_kalman as ck
    a32 = airquality_model(bt, torch.float32)
    m32 = main_path_model(bt, torch.float32)
    res = {"kernels": {}, "paths": {}}
    med = lambda fn, entry: statistics.median(            # noqa: E731
        bare_ms(fn, entry, reps=20) for _ in range(5))
    for B in (1024, 4096, 16384, 65536):
        spec = a32.build(thetas_around_init(a32, B, 29, spread=0.3))
        fn = lambda: ck.fast_smoother_ll(spec)                # noqa: E731
        res["kernels"][f"fast_smoother_ll B={B}"] = {
            "ms": time_ms(fn, reps=20),
            "bare_ms": med(fn, "bssm_fast_smoother_ll")}
        del spec
    for B in (1, 4096, 16384):
        th = thetas_around_init(m32, B, 31)
        spec = drop_batch(m32.build(th[0])) if B == 1 else m32.build(th)
        mode = spec.initial_mode.expand(B, spec.n).contiguous()
        fn = lambda: ck.laplace_step(spec, mode)              # noqa: E731
        res["kernels"][f"laplace_step B={B}"] = {
            "ms": time_ms(fn, reps=20),
            "bare_ms": med(fn, "bssm_laplace_step")}
    torch.cuda.empty_cache()
    res["digests"] = k7k8_digests(bt)
    spec1 = spec_of(m32)
    amod.approximate(spec1)
    res["paths"]["ng_api single_solve_ms"] = [
        time_ms(lambda: amod.approximate(spec1)) for _ in range(3)]
    for label, model, kw in (
            ("lg_full", a32, {}),
            ("approx_full", m32, dict(mcmc_type="approx",
                                      store_modes=True))):
        kw = dict(output_type="full", seed=1, n_chains=CHAINS // 4, **kw)
        bt.run_mcmc(model, iter=20, **kw)                 # warm-up
        r = res["paths"][label] = {"states_s": [], "chain_s": []}
        for _ in range(2):
            torch.cuda.synchronize()
            out = bt.run_mcmc(model, iter=1000, **kw)
            r["states_s"].append(out.time["states"])
            r["chain_s"].append(out.time["mcmc"])
            r["acceptance_rate"] = out.acceptance_rate
            del out
            torch.cuda.empty_cache()
    return res


def k7k8_digests(bt) -> dict:
    """SHA-256 of the outputs of ``fast_smoother_ll`` (alpha, ll) and
    ``laplace_step`` (new mode, ll, diff) on fixed inputs: the airquality
    ``bsm_lg`` at B = 1024 and 65536 float32 and 1024 float64, the lg sweep
    models at m = 1, 3, 4 (n = 40, missing y) in both dtypes at B = 256;
    the main path's model at B = 1 and 4096 float32 and 1 float64, the
    Poisson sweep models at m = 1, 3, 4 in both dtypes at B = 256.  On the
    same inputs those of the kernels that share their device functions:
    ``log_likelihood`` (K6) on each linear-Gaussian input, ``laplace_solve``
    (K1, from the step's mode) and ``rts_factors`` (K2, on K1's
    approximating model) on each non-Gaussian one.  Equal digests on two
    packages mean outputs equal to the bit."""
    import hashlib
    from bssm_tpu_torch.core.spec import drop_batch
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    sha = lambda ts: hashlib.sha256(b"".join(            # noqa: E731
        t.contiguous().cpu().numpy().tobytes() for t in ts)).hexdigest()
    out = {}
    lg = [("aq f32 B=1024", airquality_model(bt, torch.float32), 1024),
          ("aq f32 B=65536", airquality_model(bt, torch.float32), 65536),
          ("aq f64 B=1024", airquality_model(bt, torch.float64), 1024)]
    ng = [("main f32 B=1", main_path_model(bt, torch.float32), 1),
          ("main f32 B=4096", main_path_model(bt, torch.float32), 4096),
          ("main f64 B=1", main_path_model(bt, torch.float64), 1)]
    for dt in (torch.float32, torch.float64):
        tag = str(dt).replace("torch.", "")
        for m in (1, 3, 4):
            lg.append((f"m={m} {tag} B=256", lg_sweep_model(bt, m, dt), 256))
            ng.append((f"m={m} {tag} B=256",
                       sweep_model(bt, "poisson", m, dt), 256))
    for label, model, B in lg:
        spec = model.build(thetas_around_init(model, B, 71, spread=0.3))
        out["fast_smoother_ll " + label] = sha(ck.fast_smoother_ll(spec))
        out["log_likelihood " + label] = sha([ck.log_likelihood(spec)])
    for label, model, B in ng:
        th = thetas_around_init(model, B, 73)
        spec = drop_batch(model.build(th[0])) if B == 1 \
            else model.build(th)
        gen = torch.Generator(device="cuda").manual_seed(74)
        mode = (spec.initial_mode + 0.1 * torch.randn(
            (B, spec.n), dtype=model.dtype, device="cuda",
            generator=gen)).contiguous()
        out["laplace_step " + label] = sha(ck.laplace_step(spec, mode))
        if B > 1:
            sol = ck.laplace_solve(spec, mode, max(1e-8, 50.0 * float(
                torch.finfo(model.dtype).eps)), 100)
            out["laplace_solve " + label] = sha(sol)
            yt, H = amod._one_match(spec, sol[0])
            out["rts_factors " + label] = sha(ck.rts_factors(
                spec.approx_gaussian(yt, H)))
    return out


AB_READINGS = {"k2k3": k2k3_ab_readings, "big": big_ab_readings,
               "k7k8": k7k8_ab_readings}


def ab(parent: str, which: str, smi: str) -> int:
    """The one-card A/B of this package against an earlier one: ``parent``
    is a checkout of it (``git archive <rev> | tar -x -C <dir>``).  The
    script copies itself there and runs the readings ``which`` of
    ``AB_READINGS`` in four processes, parent, change, change, parent, each
    building its own kernels; prints one ``ab`` line."""
    import shutil
    from pathlib import Path
    here = Path(__file__).resolve()
    there = Path(parent).resolve() / "_ab_chip_smoke.py"
    shutil.copy(here, there)
    runs = []
    for side in ("parent", "change", "change", "parent"):
        script = there if side == "parent" else here
        p = subprocess.run([sys.executable, str(script), "--ab-side", which],
                           cwd=str(script.parent), capture_output=True,
                           text=True, timeout=900)
        lines = [json.loads(ln) for ln in p.stdout.splitlines()
                 if ln.startswith('{"ab_side"')]
        if p.returncode != 0 or not lines:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append({"side": side, **lines[-1]["ab_side"]})
    res = {"nvidia_smi": smi, "readings": which, "parent": str(parent),
           "runs": runs}
    if "digests" in runs[0]:
        # outputs equal to the bit across the two packages, and within each
        def same(a, b):
            return {k: same(a[k], b[k]) for k in a} \
                if isinstance(a, dict) else a == b
        res["bit_equal_to_parent"] = same(runs[0]["digests"],
                                          runs[1]["digests"])
        res["repeatable"] = all(runs[i]["digests"] == runs[j]["digests"]
                                for i, j in ((0, 3), (1, 2)))
    emit("ab", res)
    return 0


def small_reference(bt) -> dict:
    """The phase-2 correction on the card (kernels) against the same rows on
    the CPU (plain versions), float64, same injected randomness."""
    from bssm_tpu_torch.inference.mcmc import _make_correct_rows
    y = main_path_series()[:60]
    res = {}
    lw = {}
    rng = np.random.default_rng(3)
    th = np.log([0.1, 0.01]) + 0.4 * rng.normal(size=(64, 2))
    eps = rng.normal(size=(64, 61, 10, 2))
    us = rng.uniform(size=(64, 60, 10))
    for dev in ("cuda", "cpu"):
        model = bt.bsm_ng(y, sd_level=bt.halfnormal_prior(0.1, 1.0),
                          sd_slope=bt.halfnormal_prior(0.01, 0.1),
                          distribution="poisson", dtype=torch.float64,
                          device=dev)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                         device=dev)
        correct = _make_correct_rows(model, 10, "psi")
        lw[dev] = correct(as_t(th), None, None, eps=as_t(eps),
                          us=as_t(us))["log_w"].cpu()
    res = compare("correction.log_w card vs cpu", lw["cuda"], lw["cpu"],
                  1e-8, True)
    return res


# ---------------------------------------------------------------------------

def run_path(bt, ck, model, label: str, desc: str, chains: int, iters: int,
             required, acc_range, ess_min, plain=(), warmup: int = 20,
             **run):
    """Drives one ``run_mcmc`` path at full width: a short warm-up
    (``warmup`` iterations), launch and plain-route counts set to 0 just
    before the run and read just after, then the gates.  ``plain``: the
    wrappers whose plain versions a model outside the kernels' contract
    must take on the card; such a path must launch no kernel, and every
    other path must take no plain route.  Returns the path's JSON object
    with its ``problems``, and the run's output."""
    kw = {"output_type": "theta", "n_chains": chains, "seed": 1, **run}
    bt.run_mcmc(model, iter=warmup, **kw)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.time()
    out = bt.run_mcmc(model, iter=iters, **kw)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = dict(ck.LAUNCHES)
    plain_routes = dict(ck.PLAIN_ROUTES)
    replayed = dict(ck.REPLAYED)

    d = out.theta.shape[-1]
    w = out.flat_weights()
    finite = bool(np.isfinite(out.posterior).all()
                  and np.isfinite(out.theta).all() and np.isfinite(w).all())
    sd = out.flat_theta()
    res = {"path": label, "model": desc, "chains": chains, "iter": iters,
           "mcmc_type": out.mcmc_type, "output_type": out.output_type,
           "sampling_method": run.get("sampling_method"),
           "particles": run.get("particles"),
           "psi_resample_every": run.get("psi_resample_every", 1),
           "corr_batch": run.get("corr_batch"), "elapsed_s": elapsed,
           "time": out.time, "samples_per_s": chains * iters / elapsed,
           "acceptance_rate": out.acceptance_rate,
           "ess_is_fraction": (bt.ess_is(w) / w.size
                               if out.weights is not None else None),
           "heads_corrected": out.n_corrected, "finite": finite,
           "posterior_mean_sd": [float(bt.weighted_mean(sd[:, j], w))
                                 for j in range(d)],
           "launches": launches, "plain_routes": plain_routes,
           "replayed": replayed,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    problems = []
    for k in plain:
        if plain_routes[k] <= 0:
            problems.append(f"no plain route of {k} in this path")
    if plain and any(launches.values()):
        problems.append(f"kernels launched on a model they cannot take: "
                        f"{launches}")
    if not plain and any(plain_routes.values()):
        problems.append(f"plain routes on a model the kernels take: "
                        f"{plain_routes}")
    if not finite:
        problems.append("non-finite posterior values")
    if not acc_range[0] <= out.acceptance_rate <= acc_range[1]:
        problems.append(f"acceptance rate {out.acceptance_rate}")
    if ess_min is not None and not res["ess_is_fraction"] >= ess_min:
        problems.append(f"ESS_IS fraction {res['ess_is_fraction']}")
    for k in required:
        if launches[k] <= 0:
            problems.append(f"kernel {k} was not launched by this path")
    if out.theta.shape != (chains, iters - iters // 2, d):
        problems.append(f"theta shape {out.theta.shape}")
    for name in ("alpha", "alphahat", "Vt"):
        x = getattr(out, name)
        if x is not None and not np.isfinite(x).all():
            problems.append(f"non-finite {name}")
    res["problems"] = [f"{label}: {p}" for p in problems]
    return res, out


# ESS_IS fraction of the JAX package's gamma_airquality_N10 row at 4096
# chains x 1000 iterations on its TPU (BENCH_r05.json)
GAMMA_ESS_REF = 0.8918


def ess_fraction_check(out, ref: float, groups: int = 32) -> dict:
    """The run's ESS_IS fraction against a reference run of the same size:
    its standard error by a jackknife over ``groups`` groups of chains (the
    chains are independent, the draws within one are not), the reference's
    taken to be the same; ok when they differ by at most 4 sqrt(2) of it."""
    w = out.weights.reshape(out.weights.shape[0], -1).astype(np.float64)
    frac = lambda x: x.sum() ** 2 / (x.size * (x ** 2).sum())  # noqa: E731
    parts = np.array_split(np.arange(w.shape[0]), groups)
    loo = np.array([frac(np.delete(w, g, axis=0)) for g in parts])
    se = float(np.sqrt((groups - 1) / groups
                       * ((loo - loo.mean()) ** 2).sum()))
    est = float(frac(w))
    return {"ess_is_fraction": est, "reference": ref, "jackknife_se": se,
            "z": float((est - ref) / (np.sqrt(2.0) * se)),
            "ok": bool(abs(est - ref) <= 4.0 * np.sqrt(2.0) * se)}


def lg_states_check(summary, full) -> dict:
    """The lg_full draws against the lg_summary moments of the same theta
    chains: at every (t, j), |mean of alpha - alphahat| < 6 sqrt(Vt_tjj /
    draws).  The state draws are independent given theta, so their mean
    scatters around the exact mean of the smoothed means with a variance of
    at most Vt / draws."""
    a = full.alpha.reshape((-1,) + full.alpha.shape[2:]).astype(np.float64)
    draws = a.shape[0]
    sd = np.sqrt(np.diagonal(summary.Vt, axis1=-2, axis2=-1) / draws)
    z = np.abs(a.mean(0) - summary.alphahat) / sd
    res = {"draws": draws, "max_z": float(z.max()),
           "mean_z": float(z.mean()),
           "same_theta_chains": bool(np.array_equal(full.theta,
                                                    summary.theta)),
           "alphahat_154": summary.alphahat[-1].tolist(),
           "sd_154": np.sqrt(np.diagonal(summary.Vt[-1])).tolist()}
    res["ok"] = bool(res["same_theta_chains"] and z.max() < 6.0
                     and (np.diagonal(summary.Vt, axis1=-2,
                                      axis2=-1) > 0).all())
    return res


def lineage_ess(alpha: torch.Tensor, w: torch.Tensor) -> np.ndarray:
    """Effective number of distinct states at every t of a particle
    smoother's traced trajectories ``alpha (N, n+1, m)`` with weights ``w
    (N,)``: trajectories that share an ancestor at t share its state, so the
    weights are pooled by distinct state before 1 / sum w^2."""
    a, w = alpha.double().cpu().numpy(), w.double().cpu().numpy()
    ess = []
    for t in range(a.shape[1]):
        _, inv = np.unique(a[:, t, :], axis=0, return_inverse=True)
        W = np.bincount(inv.reshape(-1), weights=w / w.sum())
        ess.append(1.0 / (W ** 2).sum())
    return np.array(ess)


def ng_api_path(bt, ck, model, model_proper) -> dict:
    """The non-Gaussian public API on one model at its initial theta, which
    reaches the Laplace approximation through the single-model solve (K8):
    gaussian_approx, logLik (approximate, psi N = 10, bsf N = 200),
    kfilter, smoother, particle_smoother (psi N = 10, bsf N = 200) and
    suggest_N (default grid, 100 replications).  Gates: laplace_step
    launched, every output finite, suggest_N finds a candidate with sd < 1,
    and the psi and bsf particle smoothers agree at every (t, j) within 6
    combined Monte-Carlo standard errors sqrt(V_t (1 / ESS_psi,t + 1 /
    ESS_bsf,t)), V_t the approximating model's smoothed variance and ESS
    the lineage ESS of each run.  That last check runs on
    ``model_proper``, the same series with a proper initial state: from the
    main model's diffuse one (P1 = 100 I) a 200-particle bootstrap filter
    collapses (log-likelihoods of -1e3 to -1e4 against the psi filter's
    -300, seen in float32 on the CPU)."""
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.inference.filters import spec_of
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.time()
    g = bt.gaussian_approx(model)
    lls = {"approx": bt.logLik(model), "psi_N10": bt.logLik(model, 10),
           "bsf_N200": bt.logLik(model, 200, method="bsf")}
    kf = bt.kfilter(model)
    sm = bt.smoother(model)
    ps = {"psi": bt.particle_smoother(model, 10),
          "bsf": bt.particle_smoother(model, 200, method="bsf")}
    sug = bt.suggest_N(model)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = dict(ck.LAUNCHES)
    plain_routes = dict(ck.PLAIN_ROUTES)
    tensors = [g.H, g.y[torch.isfinite(g.y)], kf.at, kf.Pt, kf.logLik,
               sm.alphahat, sm.Vt, *lls.values()]
    for r in ps.values():
        tensors += [r.alphahat, r.Vt, r.logLik]
    finite = all(bool(torch.isfinite(x).all()) for x in tensors)
    # the single-model solve alone: passes, and milliseconds on the host
    # clock (one K8 launch and one host synchronisation a pass)
    spec1 = spec_of(model)
    one = amod.approximate(spec1)
    solve_ms = time_ms(lambda: amod.approximate(spec1))
    # psi against bsf on the proper initial state
    V = np.diagonal(bt.smoother(model_proper).Vt[0].double().cpu().numpy(),
                    axis1=-2, axis2=-1)
    pp = bt.particle_smoother(model_proper, 10, seed=2)
    pb = bt.particle_smoother(model_proper, 200, method="bsf", seed=2)
    e_p, e_b = (lineage_ess(r.alpha[0], r.weights[0]) for r in (pp, pb))
    se = np.sqrt(V * (1.0 / e_p + 1.0 / e_b)[:, None])
    z = np.abs(pp.alphahat[0].double().cpu().numpy()
               - pb.alphahat[0].double().cpu().numpy()) / se
    res = {"path": "ng_api",
           "model": "bsm_ng poisson level+slope, n=153, m=2, float32, at "
                    "theta_init; the psi/bsf agreement on the same series "
                    "with a1 = (1, 0), P1 = diag(1, 0.01)",
           "elapsed_s": elapsed, "launches": launches,
           "plain_routes": plain_routes, "finite": finite,
           "logLik": {k: float(v[0]) for k, v in lls.items()},
           "particle_smoother_logLik": {k: float(r.logLik[0])
                                        for k, r in ps.items()},
           "suggest_N": sug, "single_solve_niter": int(one.niter[0]),
           "single_solve_ms": solve_ms,
           "psi_vs_bsf": {"max_z": float(z.max()), "mean_z": float(z.mean()),
                          "min_ess_psi": float(e_p.min()),
                          "min_ess_bsf": float(e_b.min()),
                          "logLik_psi": float(pp.logLik[0]),
                          "logLik_bsf": float(pb.logLik[0])}}
    problems = []
    if launches["laplace_step"] <= 0:
        problems.append("kernel laplace_step was not launched by this path")
    if any(plain_routes.values()):
        problems.append(f"plain routes on a model the kernels take: "
                        f"{plain_routes}")
    if not finite:
        problems.append("non-finite outputs")
    if not sug["sd"] < 1.0:
        problems.append(f"suggest_N found no candidate with sd < 1: {sug}")
    if not z.max() < 6.0:
        problems.append(f"psi and bsf smoothers disagree, max z {z.max()}")
    res["problems"] = [f"ng_api: {p}" for p in problems]
    return res


def segment_ess(out) -> float:
    """Effective number of independent trajectories of is2 full output:
    the slots of a jump-chain segment share their head's trajectory."""
    w = out.weights.reshape(-1).astype(np.float64)
    hm = out.accepted.copy()
    hm[:, 0] = True
    W = np.bincount(np.cumsum(hm.reshape(-1)) - 1, weights=w)
    return float(W.sum() ** 2 / (W ** 2).sum())


def is_states_check(summary, full) -> dict:
    """is2_full's trajectories against is1_summary's moments (one theta
    chain, one seed): at every (t, j) the weighted mean of the draws meets
    alphahat within 6 sqrt(Vt_tjj / ESS), ESS the effective number of
    independent trajectories of the draws, as lg_states_check does."""
    w = full.weights.reshape(-1).astype(np.float64)
    a = full.alpha.reshape((-1,) + full.alpha.shape[2:])
    mean = np.einsum('s,stm->tm', w, a, dtype=np.float64) / w.sum()
    ess = segment_ess(full)
    sd = np.sqrt(np.diagonal(summary.Vt, axis1=-2, axis2=-1) / ess)
    z = np.abs(mean - summary.alphahat) / sd
    res = {"ess": ess, "max_z": float(z.max()), "mean_z": float(z.mean()),
           "same_theta_chains": bool(np.array_equal(full.theta,
                                                    summary.theta)),
           "alphahat_154": summary.alphahat[-1].tolist(),
           "sd_154": np.sqrt(np.diagonal(summary.Vt[-1])).tolist()}
    res["ok"] = bool(res["same_theta_chains"] and z.max() < 6.0)
    return res


def diagnostics_phase(bt, model, out, run: dict) -> dict:
    """``summary`` and ``check_diagnostics`` on a path's output, each
    timed; the summary's means against the weighted means computed on the
    card from the same arrays; the native library built; ``save`` then
    ``load`` equal in every field; and a run of 100 iterations resumed from
    ``last_theta`` and the final ``S`` with ``burnin=0``, whose first draws
    must lie inside the range of the stored draws (99.9% of the chains)
    with their mean within 0.1 posterior sd of the posterior mean.
    ``rhat_rank`` of each parameter is printed, not gated."""
    import dataclasses
    from pathlib import Path
    from bssm_tpu_torch import native
    from bssm_tpu_torch.inference.mcmc import McmcOutput
    problems = []
    t0 = time.time()
    rows = bt.summary(out, return_se=True)
    t_summary = time.time() - t0
    t0 = time.time()
    text = bt.check_diagnostics(out)
    t_check = time.time() - t0
    numbers = [v for r in rows for v in r.values() if not isinstance(v, str)]
    if not (np.isfinite(numbers).all() and "nan" not in text):
        problems.append("non-finite summary or diagnostics")
    d = out.theta.shape[-1]
    th = torch.as_tensor(out.theta, device="cuda").reshape(-1, d).double()
    w = torch.as_tensor(out.weights, device="cuda").reshape(-1).double()
    card = ((w[:, None] * th).sum(0) / w.sum()).cpu().numpy()
    mean = np.array([r["Mean"] for r in rows])
    rel = np.abs(mean - card) / np.abs(card)
    if not (rel <= 1e-6).all():
        problems.append(f"summary means {mean} against the card's {card}")
    lib = native.get_lib() is not None
    if not lib:
        problems.append("the native library did not build")
    path = Path(native.__file__).resolve().parent.parent / "_build" \
        / "chip_smoke_output.npz"
    t0 = time.time()
    out.save(str(path))
    back = McmcOutput.load(str(path))
    t_save = time.time() - t0
    path.unlink()
    for f in dataclasses.fields(out):
        a, b = getattr(back, f.name), getattr(out, f.name)
        same = np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b
        if not same:
            problems.append(f"save/load changed {f.name}")
    t0 = time.time()
    res = bt.run_mcmc(model, iter=100, burnin=0,
                      theta_init=back.last_theta(model), S=back.S,
                      **{**run, "seed": 2})
    t_resume = time.time() - t0
    flat = out.flat_theta()
    first = res.theta[:, 0, :]
    inside = float(((first >= flat.min(0)) & (first <= flat.max(0)))
                   .all(-1).mean())
    drift = np.abs(first.mean(0) - flat.mean(0)) / flat.std(0)
    if not (np.isfinite(res.theta).all() and np.isfinite(res.weights).all()):
        problems.append("non-finite resumed run")
    if not (inside >= 0.999 and (drift < 0.1).all()):
        problems.append(f"resumed chains start away from the posterior: "
                        f"inside {inside}, drift {drift}")
    rows = [{k: v if isinstance(v, str) else float(v) for k, v in r.items()}
            for r in rows]
    return {"draws": int(flat.shape[0]), "summary": rows,
            "summary_s": t_summary, "check_diagnostics": text,
            "check_diagnostics_s": t_check,
            "rhat_rank": {name: bt.rhat_rank(out.theta[..., j])
                          for j, name in enumerate(out.theta_names)},
            "mean_rel_err_vs_card": rel.tolist(), "native_built": lib,
            "save_load_s": t_save, "resume_s": t_resume,
            "resume_first_inside_share": inside,
            "resume_first_mean_drift_sd": drift.tolist(),
            "resume_acceptance_rate": res.acceptance_rate,
            "problems": [f"diagnostics: {p}" for p in problems]}


# ---------------------------------------------------------------------------
# the non-Gaussian MCMC options, predict / fitted and their phases
# ---------------------------------------------------------------------------

def flat_stats(out) -> dict:
    """Per parameter over the flat draws, as the JAX package's
    ``benchmarks/replications.py`` takes them: the weighted mean, its
    standard error from ``asymptotic_var`` and the ESS of
    ``estimate_ess`` (weighted variance over that asymptotic variance),
    one autocorrelation estimate each."""
    from bssm_tpu_torch.diagnostics.summary import (asymptotic_var,
                                                    weighted_var)
    w = out.flat_weights().astype(np.float64)
    res = {}
    for j, name in enumerate(out.theta_names):
        th = out.flat_theta()[:, j].astype(np.float64)
        av = max(asymptotic_var(th, w), 0.0)
        res[name] = {"mean": float(np.sum(w * th) / np.sum(w)),
                     "se": float(np.sqrt(av)),
                     "ess": float(weighted_var(th, w) / av) if av > 0
                     else float(th.size)}
    return res


def means_agree(stats: dict, ref: dict, k: float = 5.0) -> dict:
    """Each parameter's weighted mean within ``k`` combined standard errors
    of the reference run's (both ``flat_stats``)."""
    res = {}
    for name, r in ref.items():
        m1, s1 = stats[name]["mean"], stats[name]["se"]
        z = abs(m1 - r["mean"]) / max(np.hypot(s1, r["se"]), 1e-30)
        res[name] = {"mean": m1, "se": s1, "ref_mean": r["mean"],
                     "ref_se": r["se"], "z": z}
    res["ok"] = all(v["z"] < k for v in res.values())
    return res


def paired_means_agree(out, ref, k: float = 4.0) -> dict:
    """Each parameter's weighted mean of ``out`` against ``ref``'s where
    both weigh the same draws (``ref`` a ``post_correct`` of ``out``): the
    gap over the standard error of the paired difference, from each
    pooled mean's linearisation sum_c (A_c - mean W_c) / mean(W) over the
    independent chains (A_c, W_c a chain's weighted sum and weight)."""
    th = out.theta.astype(np.float64)                     # (C, S, d)
    if not np.array_equal(th, ref.theta.astype(np.float64)):
        raise ValueError("paired_means_agree: the runs' draws differ")
    means, lin = [], []
    for o in (out, ref):
        w = o.weights.astype(np.float64)                  # (C, S)
        A, W = np.einsum("cs,csd->cd", w, th), w.sum(1)
        mean = A.sum(0) / W.sum()
        means.append(mean)
        lin.append((A - mean * W[:, None]) / W.mean())
    se = (lin[0] - lin[1]).std(0, ddof=1) / np.sqrt(th.shape[0])
    res = {}
    for j, name in enumerate(out.theta_names):
        res[name] = {"mean": float(means[0][j]),
                     "ref_mean": float(means[1][j]),
                     "paired_se": float(se[j]),
                     "z": float(abs(means[0][j] - means[1][j])
                                / max(se[j], 1e-30))}
    res["ok"] = all(v["z"] < k for v in res.values())
    return res


def pm_states_check(out, ref) -> dict:
    """A pm / da run's state draws against ``is2_full``'s (another chain on
    the same model): at every (t, j) the mean of the draws within 6 sqrt(Vt
    (1 / ESS_pm + 1 / ESS_is2)) of is2_full's weighted mean.  Vt: is2_full's
    weighted variance of the draws; ESS_pm: batch means with the chains as
    batches (the chains are independent), chains x the variance of all
    draws over the variance of the chain means, per (t, j); ESS_is2:
    ``segment_ess`` of is2_full (its independent trajectories, as
    is1_summary's gate)."""
    a = out.alpha.astype(np.float64)                      # (C, S, n+1, m)
    r = ref.alpha.reshape((-1,) + ref.alpha.shape[2:])
    w = ref.weights.reshape(-1).astype(np.float64)
    mean_r = np.einsum('s,stm->tm', w, r, dtype=np.float64) / w.sum()
    var_r = np.einsum('s,stm->tm', w, np.square(r - mean_r, dtype=np.float64),
                      dtype=np.float64) / w.sum()
    flat = a.reshape((-1,) + a.shape[2:])
    ess_pm = a.shape[0] * flat.var(0) / a.mean(1).var(0)
    ess_is2 = segment_ess(ref)
    z = np.abs(flat.mean(0) - mean_r) / np.sqrt(var_r * (1.0 / ess_pm
                                                         + 1.0 / ess_is2))
    return {"max_z": float(z.max()), "mean_z": float(z.mean()),
            "min_ess_pm": float(ess_pm.min()),
            "median_ess_pm": float(np.median(ess_pm)), "ess_is2": ess_is2,
            "ok": bool(np.isfinite(z).all() and z.max() < 6.0)}


def repeats_rejected(out) -> bool:
    """Every slot whose proposal was rejected holds the previous slot's
    trajectory."""
    rej = ~out.accepted[:, 1:]
    return bool(rej.any() and np.array_equal(out.alpha[:, 1:][rej],
                                             out.alpha[:, :-1][rej]))


def option_paths(bt, ck, m32, outs, it_full: int, it_half: int,
                 lvl_slope: str, is2: dict):
    """The paths of the non-Gaussian MCMC options on the main path's model:
    the global approximation (``psi_N10_global``), SPDK (``spdk_N10``), the
    plain particle tier above 512 (``is2_psi_N1024``) and the state output
    of pm and da (``pm_psi_full_N10``, ``da_spdk_full_N10``), each with its
    own gates beside ``run_path``'s.  ``outs`` holds ``psi_N10``'s and
    ``is2_full``'s outputs, the references.  Returns the path objects and
    outputs; also times a pm/psi run with theta output, the chain-time
    reference of the state output."""
    runs = [
        run_path(bt, ck, m32, "psi_N10_global", lvl_slope, CHAINS, it_full,
                 ("fast_smoother_ll", "laplace_step", "rts_factors",
                  "psi_logw"), (0.15, 0.35), 0.5, particles=10,
                 local_approx=False, **is2),
        run_path(bt, ck, m32, "spdk_N10", lvl_slope, CHAINS, it_full,
                 ("laplace_solve", "fast_smoother_ll"), (0.15, 0.35), 0.95,
                 particles=10, **{**is2, "sampling_method": "spdk"}),
        run_path(bt, ck, m32, "is2_psi_N1024", lvl_slope, CHAINS // 4,
                 it_full, ("laplace_solve", "rts_factors"), (0.15, 0.35),
                 0.99, particles=1024, **{**is2, "corr_batch": 2048}),
        run_path(bt, ck, m32, "pm_psi_full_N10", lvl_slope, CHAINS // 4,
                 it_half, ("laplace_solve", "rts_factors"), (0.15, 0.35),
                 None, particles=10, mcmc_type="pm", sampling_method="psi",
                 output_type="full"),
        run_path(bt, ck, m32, "da_spdk_full_N10", lvl_slope, CHAINS // 4,
                 it_half, ("laplace_solve", "fast_smoother_ll"),
                 (0.05, 0.35), None, particles=10, mcmc_type="da",
                 sampling_method="spdk", output_type="full")]
    res = {r["path"]: r for r, _ in runs}
    new = {r["path"]: o for r, o in runs}
    ref = flat_stats(outs["psi_N10"])
    for label in ("psi_N10_global", "spdk_N10", "is2_psi_N1024"):
        agree = means_agree(flat_stats(new[label]), ref)
        res[label]["means_vs_psi_N10"] = agree
        if not agree["ok"]:
            res[label]["problems"].append(
                f"{label}: means disagree with psi_N10's {agree}")
    g = res["psi_N10_global"]
    if g["launches"]["fast_smoother_ll"] < it_full or \
            g["launches"]["laplace_solve"] != 0:
        g["problems"].append(f"psi_N10_global: launches {g['launches']}")
    s = res["spdk_N10"]
    if s["acceptance_rate"] != outs["psi_N10"].acceptance_rate:
        s["problems"].append("spdk_N10: acceptance differs from psi_N10's")
    b = res["is2_psi_N1024"]
    if b["launches"]["psi_big_logw"] or b["launches"]["psi_logw"]:
        b["problems"].append(f"is2_psi_N1024: a particle kernel launched "
                             f"above 512 particles {b['launches']}")
    # the pm chain with theta output on the same model and size: the
    # reference of the state output's chain time
    torch.cuda.synchronize()
    t0 = time.time()
    bt.run_mcmc(m32, iter=it_half, particles=10, mcmc_type="pm",
                sampling_method="psi", n_chains=CHAINS // 4, seed=1)
    torch.cuda.synchronize()
    theta_s = time.time() - t0
    for label in ("pm_psi_full_N10", "da_spdk_full_N10"):
        out, r = new[label], res[label]
        shape_ok = out.alpha is not None and out.alpha.shape == (
            CHAINS // 4, it_half - it_half // 2, m32.extra["n"] + 1, 2)
        st = pm_states_check(out, outs["is2_full"]) if shape_ok else {}
        r["states_check"] = st
        r["rejected_slots_repeat"] = shape_ok and repeats_rejected(out)
        if not (shape_ok and r["rejected_slots_repeat"] and st["ok"]):
            shape = None if out.alpha is None else out.alpha.shape
            r["problems"].append(f"{label}: state output {st}, shape "
                                 f"{shape}")
    res["pm_psi_full_N10"]["theta_output_elapsed_s"] = theta_s
    res["pm_psi_full_N10"]["chain_time_ratio_full_over_theta"] = \
        res["pm_psi_full_N10"]["elapsed_s"] / theta_s
    return [r for r, _ in runs], new


# bssm's poisson_series is not in the repository: a series simulated in its
# manner (a log-scale local linear trend, Poisson counts), from a seed
REPLICATION_CHAINS = 512
REPLICATION_ITER = 500          # cut from 1000 to keep the grid in budget
REPLICATION_BASE = [("approx", None, 0),
                    ("pm", "psi", 10), ("pm", "spdk", 10), ("pm", "bsf", 200),
                    ("da", "psi", 10), ("da", "spdk", 10), ("da", "bsf", 200),
                    ("is2", "psi", 10), ("is2", "spdk", 10),
                    ("is2", "bsf", 200), ("is1", "psi", 10),
                    ("is3", "psi", 10)]


def replication_model(bt, dtype=torch.float32):
    """The JAX package's replication model (``benchmarks/replications.py``)
    on a series simulated as bssm's ``poisson_series``: n = 100, slope sd
    0.01, level sd 0.1 on the log scale, Poisson counts; uniform priors on
    the sds up to twice the sd of log(max(0.1, y)), P1 = 0.1 I."""
    rng = np.random.default_rng(321)
    slope = np.cumsum(np.r_[0.0, rng.normal(0, 0.01, 99)])
    y = rng.poisson(np.exp(np.cumsum(slope + np.r_[0.0, rng.normal(
        0, 0.1, 99)]))).astype(float)
    s = float(np.std(np.log(np.maximum(0.1, y))))
    return bt.bsm_ng(y, sd_level=bt.uniform_prior(0.115, 0.0, 2 * s),
                     sd_slope=bt.uniform_prior(0.004, 0.0, 2 * s),
                     P1=np.eye(2) * 0.1, distribution="poisson",
                     dtype=dtype, device="cuda")


def replications_phase(bt, ck, iters: int = REPLICATION_ITER,
                       keep=()) -> dict:
    """The reference's replication grid: {approx, pm, da, is2, is1, is3} x
    {psi 10, spdk 10, bsf 200} as ``benchmarks/replications.py`` lists it,
    each on the local and the global approximation, 512 chains x ``iters``,
    theta output, seed 1.  One JSON line a cell in that script's row format
    plus its seconds.  Gates: every cell runs; every cell but approx has
    its weighted means within 5 combined SEs (``flat_stats``) of
    is2/bsf/local's, whose weights carry no approximation; the IS cells of
    one approximation share phase 1's acceptance to the last digit; pm/bsf
    is bit for bit the same on either approximation (the bootstrap filter
    uses none); acceptance in [0.15, 0.35], bsf cells pm [0.10, 0.45], da
    [0.03, 0.35]; no plain route.  The outputs of the cells in ``keep``
    come back under ``outputs``."""
    model = replication_model(bt)
    rows, outs, stats, problems = [], {}, {}, []
    launches = {k: 0 for k in ck.LAUNCHES}
    replayed = dict(launches)
    t_phase = time.time()
    for mt, sm, N in REPLICATION_BASE:
        for local in (True, False):
            key = (mt, sm or "-", "local" if local else "global")
            torch.cuda.synchronize()
            ck.reset_launch_counts()
            t0 = time.time()
            try:
                out = bt.run_mcmc(model, iter=iters, particles=N,
                                  mcmc_type=mt, sampling_method=sm, seed=1,
                                  output_type="theta", local_approx=local,
                                  n_chains=REPLICATION_CHAINS,
                                  corr_batch=16384)
                torch.cuda.synchronize()
            except Exception as e:        # a cell that raises fails the gate
                problems.append(f"replications {key}: {e!r}"[:300])
                continue
            row = {"mcmc_type": mt, "sampling": sm or "-", "particles": N,
                   "approx": key[2], "time_s": time.time() - t0,
                   "acceptance": out.acceptance_rate}
            stats[key] = flat_stats(out)
            for name, st in stats[key].items():
                row[f"mean_{name}"], row[f"se_{name}"] = st["mean"], st["se"]
                row[f"ess_{name}"] = st["ess"]
            row["seconds"] = row["time_s"]
            row["plain_routes"] = dict(ck.PLAIN_ROUTES)
            for k, v in ck.LAUNCHES.items():
                launches[k] += v
                replayed[k] += ck.REPLAYED[k]
            if any(ck.PLAIN_ROUTES.values()):
                problems.append(f"replications {key}: plain routes")
            lo, hi = {"pm": (0.10, 0.45), "da": (0.03, 0.35)}.get(
                mt, (0.15, 0.35)) if sm == "bsf" else (0.15, 0.35)
            if not lo <= out.acceptance_rate <= hi:
                problems.append(f"replications {key}: acceptance "
                                f"{out.acceptance_rate}")
            if not np.isfinite(out.posterior).all():
                problems.append(f"replications {key}: non-finite posterior")
            emit("replication", row)
            rows.append(row)
            outs[key] = out
    ref = stats.get(("is2", "bsf", "local"))
    z = {}
    if ref is not None:
        for key, st in stats.items():
            if key[0] == "approx":
                continue
            agree = means_agree(st, ref)
            z["/".join(key)] = {k: v["z"] for k, v in agree.items()
                                if k != "ok"}
            if not agree["ok"]:
                problems.append(f"replications {key}: means disagree with "
                                f"is2/bsf/local's {agree}")
    for loc in ("local", "global"):
        accs = {k: o.acceptance_rate for k, o in outs.items()
                if k[0].startswith("is") and k[2] == loc}
        if len(set(accs.values())) > 1:
            problems.append(f"replications: IS cells on the {loc} "
                            f"approximation differ in acceptance {accs}")
    a, b = outs.get(("pm", "bsf", "local")), outs.get(("pm", "bsf",
                                                       "global"))
    if a is None or b is None or not np.array_equal(a.theta, b.theta):
        problems.append("replications: pm/bsf differs between the local "
                        "and the global approximation")
    return {"chains": REPLICATION_CHAINS, "iter": iters,
            "cells": len(rows), "seconds": time.time() - t_phase,
            "z_vs_is2_bsf_local": z, "launches": launches,
            "replayed": replayed, "problems": problems,
            "outputs": {k: outs[k] for k in keep if k in outs}}


def global_tails(bt, model, out) -> dict:
    """Why the global approximation's psi and spdk cells read low in a deep
    grid.  ``out``: an IS run of the replication model on the global
    approximation, with its modes (cast to ``model``'s dtype, whose global
    approximation the fixed thetas use).  Its draws fall into eight bins
    of sd_slope (quantiles), 512 draws a bin; at each draw, 128
    replicates of each log-likelihood estimator give the log of the mean of
    exp(estimate): psi with 10 and 100 particles and spdk with 10 draws on
    the approximation rebuilt at the stored mode (as the correction builds
    it), psi 10 on the local approximation, each less bsf 200's, as a mean
    and SE over the bin's draws.  An unbiased estimator whose relative
    variance is V reads about V / (2 x 128) low this way: a shortfall that
    shrinks from 10 to 100 particles is a heavy tail, not a bias.  Then at
    three fixed thetas the same logs over 16384 replicates."""
    from bssm_tpu_torch.inference import approx as A
    from bssm_tpu_torch.inference import mcmc as M
    from bssm_tpu_torch.inference import particle as P
    per, reps, fixed_reps = 512, 128, 16384
    dev = model.device
    th = torch.as_tensor(out.theta_sampled.reshape(-1, 2),
                         dtype=model.dtype, device=dev)
    mo = torch.as_tensor(out.modes.reshape(-1, out.modes.shape[-1]),
                         dtype=model.dtype, device=dev)
    slope = np.exp(out.theta_sampled.reshape(-1, 2)[:, 1])
    q = np.quantile(slope, np.linspace(0, 1, 9))
    rng = np.random.default_rng(0)
    sel = np.concatenate([rng.choice(np.nonzero(
        (slope >= q[i]) & (slope <= q[i + 1]))[0], per, replace=False)
        for i in range(8)])
    local = M._approx_evaluator(model, 1e-8, 100, True)
    gen = torch.Generator(device=dev).manual_seed(3)

    def rebuilt(t, m):
        spec = model.build(t)
        ar = A.approximate_for_is(spec, m)
        return spec, ar, A.rebuilt_loglik(spec, ar)

    def glo_psi(N):
        def f(t, m):
            spec, ar, base = rebuilt(t, m)
            return base + P.psi_logw(spec, M._psi_al(spec, ar), N, gen)
        return f

    def glo_spdk(t, m):
        spec, ar, base = rebuilt(t, m)
        al = M._psi_al(spec, ar)._replace(loglik=base)
        return P.spdk_sample(spec, al, 10, gen).loglik

    def loc_psi(t, m):
        spec = model.build(t)
        ll, mode = local.evaluate(spec)
        ar = A.approximate_for_is(spec, mode)
        return ll + P.psi_logw(spec, M._psi_al(spec, ar), 10, gen)

    def bsf(t, m):
        return P.bsf_logw(model.build(t), 200, gen)

    def log_mean_exp(v):                       # (rows, reps) -> (rows,)
        v = v.double()
        mx = v.max(-1, keepdim=True).values
        return torch.log(torch.exp(v - mx).mean(-1)) + mx[..., 0]

    fns = {"glo_psi10": glo_psi(10), "glo_psi100": glo_psi(100),
           "glo_spdk10": glo_spdk, "loc_psi10": loc_psi, "bsf200": bsf}
    step = max(1, 16384 // reps)
    per_draw = {}
    for name, fn in fns.items():
        parts = []
        for lo in range(0, sel.size, step):
            rows = torch.as_tensor(sel[lo:lo + step],
                                   device=dev).repeat_interleave(reps)
            parts.append(log_mean_exp(fn(th[rows], mo[rows]).reshape(
                -1, reps)))
        per_draw[name] = torch.cat(parts).cpu().numpy()
    bins = np.repeat(np.arange(8), per)
    res = {"draws_per_bin": per, "reps": reps,
           "sd_slope_bin_edges": q.tolist(),
           "sd_level_bin_means": [float(np.exp(out.theta_sampled.reshape(
               -1, 2)[sel[bins == i], 0]).mean()) for i in range(8)]}
    for name in fns:
        if name != "bsf200":
            d = per_draw[name] - per_draw["bsf200"]
            res[f"{name}_less_bsf200"] = [
                [float(d[bins == i].mean()),
                 float(d[bins == i].std() / np.sqrt(per))]
                for i in range(8)]
    fixed = {}
    for sd_slope in (0.02, 0.045, 0.08):
        t = torch.tensor(np.log([0.19, sd_slope]), dtype=model.dtype,
                         device=dev).expand(fixed_reps, -1).contiguous()
        _, mode = M._approx_evaluator(model, 1e-8, 100, False).evaluate(
            model.build(t))
        row = {}
        for name in ("glo_psi10", "glo_psi100", "bsf200"):
            v = fns[name](t, mode).double()
            w = torch.exp(v - v.max())
            row[name] = [float(log_mean_exp(v)),
                         float(w.std() / w.mean() / np.sqrt(v.numel()))]
        fixed[f"0.19,{sd_slope}"] = row
    res["fixed_theta"] = {"reps": fixed_reps, **fixed}
    return res


def jackknife_loglik(ll: torch.Tensor, groups: int = 64) -> tuple:
    """log of the mean of exp(ll) over rows (each row an unbiased
    likelihood estimate at one theta) and its jackknife standard error over
    ``groups`` groups of rows."""
    x = ll.double().cpu().numpy()
    mx = x.max()
    e = np.exp(x - mx)
    est = float(np.log(e.mean()) + mx)
    parts = np.array_split(np.arange(x.size), groups)
    loo = np.array([np.log(np.delete(e, p).mean()) + mx for p in parts])
    se = float(np.sqrt((groups - 1) / groups
                       * ((loo - loo.mean()) ** 2).sum()))
    return est, se


def bign_checks(bt, ck, m32, mb32) -> dict:
    """The particle filters on both sides of 512 particles at one theta,
    4096 rows: the bootstrap filter on ``pm_bsf_N200``'s model at N = 1024
    (the plain tier) and 512 (K5), the psi filter on the main path's model
    at N = 1024 (plain) and 512 (K4).  Each row is an unbiased likelihood
    estimate, so the logs of the row means of exp(ll) agree within 5
    combined jackknife SEs.  The plain tier at N = 640 fed a generator
    equals, to the bit, itself fed the tensors ``stream_draws`` makes from a
    generator in the same state (256 rows).  Times the plain tier per call
    and per time step."""
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.inference import particle as pf
    from bssm_tpu_torch.inference.mcmc import _psi_al
    B = BIGN_ROWS
    res, problems = {}, []
    for label, model, method in (("bsf", mb32, "bsf"), ("psi", m32, "psi")):
        th = torch.as_tensor(model.theta_init, dtype=torch.float32,
                             device="cuda").expand(B, -1)
        spec = model.build(th)
        al = None
        if method == "psi":
            al = _psi_al(spec, amod.approximate(spec))
        est = {}
        for N in (1024, 512):
            gen = torch.Generator(device="cuda").manual_seed(N)
            before = dict(ck.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.time()
            ll = pf.bsf_logw(spec, N, gen) if method == "bsf" \
                else pf.psi_logw(spec, al, N, gen)
            torch.cuda.synchronize()
            sec = time.time() - t0
            rise = {k: v - before[k] for k, v in ck.LAUNCHES.items()
                    if v != before[k]}
            e, se = jackknife_loglik(ll)
            est[N] = {"log_mean_lik": e, "jackknife_se": se, "seconds": sec,
                      "launches": rise,
                      "finite": bool(torch.isfinite(ll).all())}
            kernel = "bsf_big_logw" if method == "bsf" else "psi_big_logw"
            if (N > ck.MAX_N_BIG) == (rise.get(kernel, 0) > 0):
                problems.append(f"bign {label} N={N}: launches {rise}")
            if not est[N]["finite"]:
                problems.append(f"bign {label} N={N}: non-finite")
        z = abs(est[1024]["log_mean_lik"] - est[512]["log_mean_lik"]) / \
            np.hypot(est[1024]["jackknife_se"], est[512]["jackknife_se"])
        est["z"] = float(z)
        est["plain_ms_per_step"] = est[1024]["seconds"] * 1e3 / spec.n
        if not z < 5.0:
            problems.append(f"bign {label}: N=1024 and N=512 disagree, z {z}")
        # the plain tier's per-step draws are the injected stream
        small = model.build(th[:min(256, B)])
        sal = None if al is None else _psi_al(small, amod.approximate(small))
        steps = spec.n + 1 if method == "psi" else spec.n
        a_gen = torch.Generator(device="cuda").manual_seed(7)
        eps, us = pf.stream_draws(torch.Generator(device="cuda").manual_seed(
            7), small.batch, steps, 640, spec.m, torch.float32, "cuda")
        if method == "bsf":
            a = pf.bsf_logw(small, 640, a_gen)
            b = pf.bsf_logw(small, 640, eps=eps, us=us)
        else:
            a = pf.psi_logw(small, sal, 640, a_gen)
            b = pf.psi_logw(small, sal, 640, eps=eps, us=us)
        est["N640_stream_bit_equal"] = bool(torch.equal(a, b))
        if not est["N640_stream_bit_equal"]:
            problems.append(f"bign {label}: N=640 generator and stream "
                            "differ")
        res[label] = est
    res["problems"] = problems
    return res


BIGN_ROWS = 4096                # rows of bign_checks
K7_ROWS = {"global": 4096, "spdk": 16384}   # models of global_checks
PREDICT_DRAWS = 100000
FAMILY_DRAWS = 10 ** 6

# the wrapper's readings of fast_smoother_ll at the linear-Gaussian shapes
# in the previous kernels line (PERF.md section 6), printed beside these
EARLIER_K7_MS = {"B4096": 0.12192, "B65536": 0.44378}


def global_checks(bt, ck) -> dict:
    """K7 against its plain version on the card at the two shapes the new
    paths give it, float32 and float64: the global approximation's (y and H
    the frozen series, stride-0 views shared by 4096 rows, the system per
    row), also against the same rows with y and H materialised (to the
    bit); and SPDK's (16384 models x 5 simulated series, the system
    repeated per series, ``simsmooth.repeat_rows``).  Times the wrapper and
    the bare kernel in float32."""
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.ops import kalman
    from bssm_tpu_torch.ops.simsmooth import repeat_rows
    rule = kalman.degenerate_h2rr
    out = {"earlier_wrapper_ms": EARLIER_K7_MS, "runs": []}
    for dt in (torch.float32, torch.float64):
        model = main_path_model(bt, dt)
        ga = amod.global_approximation(model)
        f64 = dt == torch.float64
        for label, B in K7_ROWS.items():
            spec = model.build(thetas_around_init(model, B, 53, spread=0.3))
            if label == "global":
                g = spec.approx_gaussian(ga.ytilde.expand(B, -1),
                                         ga.Htilde.expand(B, -1))
            else:
                g = repeat_rows(amod.approximate(spec).gaussian(spec), 5)
                noise = torch.randn(g.y.shape, dtype=dt, device="cuda",
                                    generator=torch.Generator(
                                        device="cuda").manual_seed(5))
                g = g._replace(y=g.y + 0.3 * noise)
            rows = g.batch
            k_a, k_l = ck.fast_smoother_ll(g)
            p_a, p_l = kalman.fast_smoother_ll(g, degenerate=rule)
            torch.cuda.synchronize()
            scale = p_a.double().abs().flatten(1).max(1).values[:, None, None]
            tol = (F64_TOL, F64_TOL) if f64 else (1e-5, 2e-5)
            atol = F64_TOL if f64 else 3e-4 * (1.0 + scale)
            run = {"shape": label, "rows": rows, "dtype": str(dt)[6:],
                   "checks": [
                       compare_lg(f"fast_smoother_ll.ll {label}", k_l, p_l,
                                  *tol),
                       compare_lg(f"fast_smoother_ll.alpha {label}", k_a, p_a,
                                  atol, F64_TOL if f64 else 0.0)]}
            if label == "global":
                dense = g._replace(y=g.y.contiguous(), H=g.H.contiguous())
                d_a, d_l = ck.fast_smoother_ll(dense)
                run["stride0_bit_equal_to_dense"] = bool(
                    torch.equal(d_a, k_a) and torch.equal(d_l, k_l))
                if not run["stride0_bit_equal_to_dense"]:
                    FAILURES.append({"what": "fast_smoother_ll: stride-0 y "
                                             "and H differ from dense"})
            if not f64:
                run["ms"] = time_ms(lambda: ck.fast_smoother_ll(g))
                run["bare_ms"] = bare_ms(lambda: ck.fast_smoother_ll(g),
                                         "bssm_fast_smoother_ll")
                run["plain_ms"] = time_ms(lambda: kalman.fast_smoother_ll(
                    g, degenerate=rule), reps=1, warmup=0)
                run["bounds"] = lg_bounds(g, rows, dt)["fast_smoother_ll"]
                run["fs_geometry"] = ck.fs_geometry(
                    g.n, g.m, g.y.element_size(), rows,
                    ck._sm_count(0))._asdict()
            out["runs"].append(run)
    return out


def replay_checks(bt, m32, mb32) -> list:
    """The CUDA-graph replay of pm / da's estimates with states
    (``inference/replay.py``) against the same calls run eagerly, on the
    same generator state: psi and spdk on the main path's model, bsf on
    ``pm_bsf_N200``'s, 1024 rows, N = 10.  The first call captures the
    graph on other thetas; the second, a replay on new inputs, must give
    the eager call's bits."""
    from bssm_tpu_torch.inference import mcmc as M
    from bssm_tpu_torch.inference.replay import Replay
    res = []
    for method, model in (("psi", m32), ("spdk", m32), ("bsf", mb32)):
        approx = M._approx_evaluator(model, 1e-8, 100)
        th = thetas_around_init(model, 1024, 61, spread=0.2)
        other = thetas_around_init(model, 1024, 62, spread=0.2)
        replay = Replay()
        got = []
        for rp, t, seed in ((replay, other, 8), (replay, th, 9),
                            (None, th, 9)):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            got.append(M._pf_loglik(model, t, gen, 10, method, approx,
                                    need_states=True, replay=rp))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got[1], got[2]))
        res.append({"method": method, "replay_bit_equal_to_eager": same})
        if not same:
            FAILURES.append({"what": f"replay of the {method} estimate "
                                     "differs from the eager call"})
    return res


def predict_fitted_phase(bt, m32, outs) -> dict:
    """``fitted`` and ``predict`` on ``pm_psi_full_N10``'s and
    ``is2_full``'s outputs, and the observation samplers per family.
    Gates: fitted(type="mean") averaged over the draws (weighted) equals
    the weighted mean of exp(Z alpha) computed on the card from the same
    draws, to 1e-5 relative; predict over a 24-step future model (y all
    NaN), types state / mean / response, 100000 draws: every value finite,
    the response's sample mean within 6 SEs of the mean draws' at every
    horizon; 10^6 observation draws of each family at a fixed signal, u and
    phi: mean and variance within 6 SEs of their closed forms."""
    from bssm_tpu_torch.core import spec as S
    from bssm_tpu_torch.inference import predict as P
    problems, res = [], {}
    for label in ("pm_psi_full_N10", "is2_full"):
        out = outs[label]
        torch.cuda.synchronize()
        t0 = time.time()
        f = bt.fitted(out, m32)
        t_fit = time.time() - t0
        w = out.flat_weights().astype(np.float64)
        fit_mean = (w[:, None] * f.astype(np.float64)).sum(0) / w.sum()
        a = torch.as_tensor(out.alpha.reshape((-1,) + out.alpha.shape[2:]),
                            device="cuda")
        sig = a[:, :-1, 0]                           # Z = (1, 0), D = 0
        wt = torch.as_tensor(w, device="cuda")
        card = ((wt[:, None] * torch.exp(sig).double()).sum(0)
                / wt.sum()).cpu().numpy()
        rel = float(np.max(np.abs(fit_mean - card) / np.abs(card)))
        fut = bt.bsm_ng(np.full(24, np.nan),
                        sd_level=bt.halfnormal_prior(0.1, 1.0),
                        sd_slope=bt.halfnormal_prior(0.01, 0.1),
                        distribution="poisson", dtype=torch.float32,
                        device="cuda")
        pr, t_pr = {}, {}
        for typ in ("state", "mean", "response"):
            torch.cuda.synchronize()
            t0 = time.time()
            pr[typ] = bt.predict(out, fut, typ, PREDICT_DRAWS, seed=3)
            t_pr[typ] = time.time() - t0
        fin = all(np.isfinite(v).all() for v in pr.values())
        m_r, m_m = pr["response"].astype(np.float64), \
            pr["mean"].astype(np.float64)
        z = np.abs(m_r.mean(0) - m_m.mean(0)) / np.sqrt(
            m_r.var(0) / m_r.shape[0] + m_m.var(0) / m_m.shape[0])
        res[label] = {"draws": int(f.shape[0]), "fitted_s": t_fit,
                      "fitted_max_rel_err": rel, "predict_s": t_pr,
                      "predict_finite": fin,
                      "response_vs_mean_max_z": float(z.max()),
                      "predict_mean_h24": float(m_m[:, -1].mean())}
        if not (rel <= 1e-5 and fin and z.max() < 6.0
                and f.shape == (out.alpha.shape[0] * out.alpha.shape[1],
                                m32.extra["n"])):
            problems.append(f"predict_fitted {label}: {res[label]}")
    # observation samplers at a fixed signal, u and phi
    N = FAMILY_DRAWS
    gen = torch.Generator(device="cuda").manual_seed(11)
    s, u, phi = 0.4, 3.0, 2.5
    sig = torch.full((N, 1), s, dtype=torch.float64, device="cuda")
    ut = torch.full((1, 1), u, dtype=torch.float64, device="cuda")
    ph = torch.tensor(phi, dtype=torch.float64, device="cuda")
    mu, p = u * np.exp(s), 1.0 / (1.0 + np.exp(-s))
    closed = {"poisson": (S.POISSON, mu, mu),
              "binomial": (S.BINOMIAL, u * p, u * p * (1 - p)),
              "negative binomial": (S.NEGBIN, mu, mu + mu * mu / phi),
              "gamma": (S.GAMMA, mu, mu * mu / phi),
              "gaussian": (S.GAUSSIAN, s, phi * phi)}
    fam = {}
    for name, (code, mean, var) in closed.items():
        x = P._family_sample(code, gen, sig, ut, ph)
        fam[name] = x
    # the SV family: phi exp(alpha / 2) eps, signal = the first state
    sv = bt.svm(np.ones(2), rho=bt.uniform_prior(0.9, -0.999, 0.999),
                sd_ar=bt.halfnormal_prior(0.3, 1.0),
                sigma=bt.halfnormal_prior(phi, 5.0), dtype=torch.float64,
                device="cuda")
    spec = sv.build(torch.as_tensor(sv.theta_init, device="cuda").expand(
        N // 2, -1))
    alpha = torch.full((N // 2, 2, 1), s, dtype=torch.float64, device="cuda")
    fam["sv"] = P._obs_sample(spec, alpha[..., 0], alpha, gen).reshape(-1, 1)
    closed["sv"] = (S.SVM, 0.0, phi * phi * np.exp(s))
    for name, x in fam.items():
        _, mean, var = closed[name]
        x = x.reshape(-1).double()
        n_ = x.numel()
        m_, v_ = float(x.mean()), float(x.var())
        m4 = float(((x - m_) ** 4).mean())
        z_m = abs(m_ - mean) / np.sqrt(var / n_)
        z_v = abs(v_ - var) / np.sqrt(max(m4 - v_ * v_, 1e-300) / n_)
        fam[name] = {"draws": n_, "mean": m_, "closed_mean": mean, "var": v_,
                     "closed_var": var, "z_mean": z_m, "z_var": z_v}
        if not (z_m < 6.0 and z_v < 6.0):
            problems.append(f"predict_fitted sampler {name}: {fam[name]}")
    res["families"] = fam
    res["problems"] = problems
    return res


def options_section(bt, ck, m32, mb32, outs, it_full, it_half, lvl_slope,
                    is2) -> tuple:
    """The new paths and the phases ``replications``, ``bign_checks``,
    ``global_checks`` and ``predict_fitted``, each emitted on its own line.
    Returns (path objects, outputs, phase objects, problems)."""
    t0 = time.time()
    paths, new = option_paths(bt, ck, m32, outs, it_full, it_half,
                              lvl_slope, is2)
    t_paths = time.time() - t0
    phases = {}
    for name, fn in (
            ("replications", lambda: replications_phase(bt, ck)),
            ("bign_checks", lambda: bign_checks(bt, ck, m32, mb32)),
            ("global_checks", lambda: {**global_checks(bt, ck),
                                       "replay": replay_checks(bt, m32,
                                                               mb32)}),
            ("predict_fitted", lambda: predict_fitted_phase(
                bt, m32, {**outs, **new}))):
        t1 = time.time()
        try:
            ph = fn()
        except Exception as e:               # a failed phase fails the run
            ph = {"problems": [f"{name}: {e!r}"[:400]]}
        ph["phase_s"] = time.time() - t1
        ph.pop("outputs", None)
        phases[name] = ph
        emit(name, ph)
    problems = [p for r in paths for p in r["problems"]]
    for name, ph in phases.items():
        problems += ph.get("problems", [])
    if FAILURES:
        problems.append(f"kernel checks failed: {FAILURES}"[:600])
    phases["seconds"] = {"paths": t_paths,
                         **{k: v["phase_s"] for k, v in phases.items()}}
    return paths, new, phases, problems


# ---------------------------------------------------------------------------
# the multivariate models: batched tensor code, no kernel
# ---------------------------------------------------------------------------

MV_CHAINS = 1024
MV_ITER = 300                   # the mng paths; cut for the 120 s budget
# theta of the bivariate airquality model: the sds of Ozone's and Temp's
# observation noise, then of their levels (untransformed, as ssm_* samples)
MLG_INIT = np.array([20.0, 5.0, 5.0, 2.0])
MLG_GAMMA = ((2.0, 0.1), (2.0, 0.4))        # (shape, rate) of the obs sds
MLG_HALFNORMAL = (20.0, 5.0)                 # scales of the level sds


def mlg_airquality_model(bt, dtype):
    """bssm's README multivariate example as ``ssm_mlg`` (the reference is
    not mounted; this is the form used): airquality's Ozone and Temp (n =
    153, p = 2; Ozone's 37 NAs leave rows partly missing), a local level
    each (m = 2, Z = T = I), H and R diagonal from a batched ``update_fn``
    (d = 4: the two observation sds, then the two level sds), gamma priors
    on the observation sds and half-normal ones on the level sds, a1 the
    series' means, P1 = diag(1000, 100)."""
    aq = bt.airquality()
    y = np.column_stack([aq["Ozone"], aq["Temp"]])

    def update_fn(theta):
        return {"H": torch.diag_embed(theta[:, :2])[:, None],
                "R": torch.diag_embed(theta[:, 2:])[:, None]}

    def prior_fn(theta):
        lp = 0.0
        for j, (k, r) in enumerate(MLG_GAMMA):
            lp = lp + (k - 1.0) * torch.log(theta[:, j].clamp(min=1e-30)) \
                - r * theta[:, j]
        for j, sc in enumerate(MLG_HALFNORMAL):
            lp = lp - 0.5 * torch.square(theta[:, 2 + j] / sc)
        return torch.where((theta > 0).all(-1), lp,
                           torch.full_like(lp, -torch.inf))

    return bt.ssm_mlg(y, Z=np.eye(2), H=np.diag(MLG_INIT[:2]), T=np.eye(2),
                      R=np.diag(MLG_INIT[2:]), a1=np.nanmean(y, axis=0),
                      P1=np.diag([1000.0, 100.0]), init_theta=MLG_INIT,
                      update_fn=update_fn, prior_fn=prior_fn,
                      theta_names=("sd_y_ozone", "sd_y_temp",
                                   "sd_level_ozone", "sd_level_temp"),
                      dtype=dtype, device="cuda")


def _zoo_draws():
    """The JAX package zoo's numpy draws replayed from ``default_rng(7)``
    in the zoo's order (``benchmarks/zoo_tpu.py:64-160``) up to its
    Poisson + Gaussian series: (the generator after them, that series)."""
    rng = np.random.default_rng(7)
    rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, 100))))
    seas = 0.4 * np.sin(2 * np.pi * np.arange(120) / 12)
    rng.poisson(np.exp(0.5 + seas + np.cumsum(rng.normal(0, 0.05, 120))))
    rng.normal(0, 1, 200)
    return rng, np.column_stack([
        rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, 80)))),
        rng.normal(0, 1, 80).cumsum()]).astype(float)


def zoo_mng_series() -> np.ndarray:
    """The JAX package zoo's Poisson + Gaussian series (n = 80, p = 2)."""
    return _zoo_draws()[1]


def zoo_update(theta):
    """R = exp(theta) I of the zoo's ``ssm_mng``, batched over chains."""
    return {"R": torch.exp(theta[:, 0])[:, None, None, None]
            * torch.eye(2, dtype=theta.dtype, device=theta.device)}


ZOO_KW = dict(T=0.95 * np.eye(2), R=0.2 * np.eye(2), P1=np.eye(2),
              init_theta=(np.log(0.2),), update_fn=zoo_update,
              prior_fn=lambda th: -0.5 * (th ** 2).sum(-1), device="cuda")


def zoo_mng_model(bt, dtype, p: int = 2, y=None):
    """The zoo's ``ssm_mng(pois+gauss)`` (``benchmarks/zoo_tpu.py:157-170``):
    Z = I, T = 0.95 I, R = exp(theta) I (d = 1, theta ~ N(0, 1) a priori,
    theta_init log 0.2), P1 = I, phi = 1, on ``zoo_mng_series`` unless ``y``
    (a future: NaN) is given.  ``p = 1`` keeps the Poisson series alone
    (Z = (1, 0)): the univariate reduction."""
    y = zoo_mng_series()[:, :p] if y is None else y
    return bt.ssm_mng(y, Z=np.eye(2)[:p],
                      distributions=["poisson", "gaussian"][:p],
                      phi=np.ones(p), theta_names=("log_sd_state",),
                      dtype=dtype, **ZOO_KW)


def zoo_ung_model(bt, dtype):
    """The p = 1 reduction of ``zoo_mng_model`` as the port's ``ssm_ung``."""
    return bt.ssm_ung(zoo_mng_series()[:, 0], Z=np.array([1.0, 0.0]),
                      distribution="poisson", dtype=dtype, **ZOO_KW)


def mv_iteration_ops(bt, model, kind: str, B: int) -> dict:
    """What paces a multivariate chain iteration: the device operations of
    the blocks it repeats, counted by stream capture, and their eager and
    replayed milliseconds (CUDA events) at ``B`` rows, theta_init.  mlg:
    the log-likelihood, once an iteration.  mng: one Laplace pass (an
    evaluation runs ``passes`` of them, the mean over the rows) and the
    psi filter's estimate at N = 10 (pm / da, once an iteration)."""
    from bssm_tpu_torch.inference import approx_mv as amv
    from bssm_tpu_torch.inference import mcmc as tm
    from bssm_tpu_torch.inference.replay import Replay
    th = torch.as_tensor(model.theta_init, dtype=torch.float32,
                         device="cuda").expand(B, -1).contiguous()
    spec = model.build(th)
    rp = Replay()
    res = {"rows": B}
    if kind == "mlg":
        blocks = {"log_likelihood": (tm._loglik_mv, (spec,))}
    else:
        al = amv.approx_loglik_mv(spec)
        res["passes"] = float(al.approx.niter.float().mean())
        gen = torch.Generator(device="cuda").manual_seed(5)
        eps = torch.randn((B, spec.n + 1, 10, spec.m), generator=gen,
                          device="cuda")
        us = torch.rand((B, spec.n, 10), generator=gen, device="cuda")
        blocks = {"laplace_pass": (amv._laplace_step_mv,
                                   (spec, al.approx.mode)),
                  "psi_estimate_N10": (tm._psi_states_mv,
                                       (spec, al, eps, us, None))}
    for name, (fn, args) in blocks.items():
        eager = fn(*args)
        replayed = rp(fn, *args)
        same = all(torch.equal(a, b) for a, b in zip(eager, replayed))
        res[name] = {"device_ops": len(graph_nodes(lambda: fn(*args))),
                     "eager_ms": time_ms(lambda: fn(*args)),
                     "replayed_ms": time_ms(lambda: rp(fn, *args)),
                     "replay_bit_equal_to_eager": same}
        if not same:
            FAILURES.append({"what": f"{kind} {name}: replay differs from "
                                     "the eager call"})
    if kind == "mlg":
        res["device_ops_per_iteration"] = res["log_likelihood"]["device_ops"]
    else:
        res["device_ops_per_evaluation"] = \
            res["passes"] * res["laplace_pass"]["device_ops"]
    return res


def mv_no_kernels(r: dict, ck) -> None:
    """Gate of every multivariate path: no kernel launched, replayed or
    routed plain (the models reach no kernel)."""
    bad = {k: v for k, v in {**r["launches"], **r["plain_routes"],
                             **r.get("replayed", {})}.items() if v}
    if bad:
        r["problems"].append(f"{r['path']}: kernel counts {bad}")


def mv_api_phase(bt, ck, model, model_p1, ung, thetas) -> dict:
    """The public API on the zoo's mng at theta_init, its launches counted
    (all must stay 0), then its p = 1 reduction against the port's
    ``ssm_ung`` (which runs the kernels, outside the counted window): the
    approximate log-likelihood to 1e-4 relative and the mode to 1e-4 at
    ``thetas`` (float32), and the psi log-likelihood (N = 10, 4096
    replications at theta_init) within 5 jackknife standard errors."""
    from bssm_tpu_torch.inference import approx_mv as amv
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.time()
    lls = {"approx": bt.logLik(model), "psi_N10": bt.logLik(model, 10),
           "bsf_N200": bt.logLik(model, 200, method="bsf"),
           "spdk_N10": bt.logLik(model, 10, method="spdk")}
    imp = bt.importance_sample(model, 100)
    kf = bt.kfilter(model)
    fs = bt.fast_smoother(model)
    sm = bt.smoother(model)
    ss = bt.sim_smoother(model, 8)
    ps = bt.particle_smoother(model, 10)
    ap = bt.run_mcmc(model, iter=40, mcmc_type="approx", output_type="full",
                     n_chains=64, seed=2)
    fut = zoo_mng_model(bt, torch.float32, y=np.full((12, 2), np.nan))
    pr = bt.predict(ap, fut, "response", 4096, seed=3)
    fi = bt.fitted(ap, model)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    res = {"path": "mv_api", "model": "the zoo's ssm_mng(pois+gauss) at "
           "theta_init, n=80, p=2, m=2, float32; its p = 1 reduction "
           "against ssm_ung", "elapsed_s": elapsed,
           "launches": dict(ck.LAUNCHES), "plain_routes":
           dict(ck.PLAIN_ROUTES), "replayed": dict(ck.REPLAYED),
           "logLik": {k: float(v[0]) for k, v in lls.items()},
           "importance_sample_loglik": float(imp.loglik),
           "predict_shape": list(pr.shape), "fitted_shape": list(fi.shape)}
    tensors = [*lls.values(), imp.alpha, imp.weights, kf.at, kf.Pt, fs,
               sm.alphahat, sm.Vt, ss, ps.alphahat, ps.Vt]
    finite = all(bool(torch.isfinite(x).all()) for x in tensors) and bool(
        np.isfinite(pr).all() and np.isfinite(fi).all()
        and np.isfinite(ap.alpha).all())
    res["finite"] = finite
    problems = []
    if not finite:
        problems.append("non-finite outputs")
    if pr.shape != (4096, 12, 2) or fi.shape != (64 * 20, 80, 2):
        problems.append(f"predict {pr.shape} / fitted {fi.shape}")
    res["problems"] = problems
    mv_no_kernels(res, ck)
    # the p = 1 reduction against ssm_ung
    th = torch.as_tensor(thetas, dtype=torch.float32, device="cuda")
    a_mv = amv.approx_loglik_mv(model_p1.build(th))
    a_u = bt.approx_loglik(ung.build(th))
    rel = float(((a_mv.loglik - a_u.loglik).abs()
                 / a_u.loglik.abs()).max())
    mode_err = float((a_mv.approx.mode[..., 0] - a_u.approx.mode).abs()
                     .max())
    R = 4096
    th0 = torch.as_tensor(model_p1.theta_init, dtype=torch.float32,
                          device="cuda").expand(R, -1).contiguous()
    s_mv, s_u = model_p1.build(th0), ung.build(th0)
    al_mv = amv.approx_loglik_mv(s_mv)
    al_u = bt.approx_loglik(s_u)
    gen = torch.Generator(device="cuda").manual_seed(9)
    ll_mv = amv.psi_filter_mv(s_mv, al_mv, 10, gen, keep_paths=False)
    ll_u = bt.psi_logw(s_u, al_u, 10, gen)
    (e_mv, se_mv), (e_u, se_u) = jackknife_loglik(ll_mv), \
        jackknife_loglik(ll_u)
    z = abs(e_mv - e_u) / max(np.hypot(se_mv, se_u), 1e-30)
    res["p1_vs_ssm_ung"] = {"thetas": len(thetas),
                            "approx_loglik_max_rel_err": rel,
                            "mode_max_abs_err": mode_err,
                            "psi_loglik_mv": e_mv, "psi_loglik_se_mv": se_mv,
                            "psi_loglik_ung": e_u, "psi_loglik_se_ung": se_u,
                            "z": z}
    if not (rel <= 1e-4 and mode_err <= 1e-4 and z < 5.0):
        res["problems"].append(f"mv_api: p = 1 against ssm_ung "
                               f"{res['p1_vs_ssm_ung']}")
    return res


def mv_section(bt, ck, it_mlg: int, it_mng: int):
    """The multivariate paths (``mlg_gaussian``, ``mng_is2_psi_N10``,
    ``mng_da_psi_N10``) and the ``mv_api`` phase, with what paces them
    (``mv_iteration_ops``).  Each path has ``run_path``'s gates, no
    kernel count may rise, and its own gates: mlg_gaussian, its full
    draws within 6 sqrt(Vt / draws) of the smoothed moments over the same
    thetas (``smoother_mv``, ``lg_states_check``); mng_is2_psi_N10, is2/bsf
    N = 200 on the same phase-1 chain (``post_correct``) and psi's
    weighted means within 5 combined SEs of bsf's.  Returns (path objects,
    problems)."""
    from bssm_tpu_torch.inference import mcmc as tm
    mlg = mlg_airquality_model(bt, torch.float32)
    mng = zoo_mng_model(bt, torch.float32)
    ops = {"mlg": mv_iteration_ops(bt, mlg, "mlg", MV_CHAINS),
           "mng": mv_iteration_ops(bt, mng, "mng", MV_CHAINS)}
    emit("mv_ops", {**ops, "failures": FAILURES})
    aq = "ssm_mlg airquality Ozone + Temp, local level each (H, R " \
        "diagonal from update_fn), n=153, p=2, m=2, d=4, float32"
    zoo = "ssm_mng poisson + gaussian (the zoo's), n=80, p=2, m=2, d=1, " \
        "float32"
    r_lg, o_lg = run_path(bt, ck, mlg, "mlg_gaussian", aq, MV_CHAINS,
                          it_mlg, (), (0.15, 0.6), None,
                          output_type="full")
    t0 = time.time()
    ah, Vt = tm._state_summary(mlg, torch.as_tensor(
        o_lg.theta, device="cuda"), 65536)
    from types import SimpleNamespace
    summ = SimpleNamespace(alphahat=ah.cpu().numpy(), Vt=Vt.cpu().numpy(),
                           theta=o_lg.theta)
    r_lg["summary_s"] = time.time() - t0
    r_lg["states_check"] = lg_states_check(summ, o_lg)
    if not r_lg["states_check"]["ok"]:
        r_lg["problems"].append(f"mlg_gaussian: draws disagree with the "
                                f"smoother {r_lg['states_check']}")
    r_lg["posterior_mean"] = dict(zip(o_lg.theta_names,
                                      o_lg.flat_theta().mean(0).tolist()))
    r_is, o_is = run_path(bt, ck, mng, "mng_is2_psi_N10", zoo, MV_CHAINS,
                          it_mng, (), (0.15, 0.35), None, particles=10,
                          mcmc_type="is2", sampling_method="psi",
                          corr_batch=65536)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.time()
    bsf = bt.post_correct(mng, o_is, 200, sampling_method="bsf",
                          output_type="theta", corr_batch=16384, seed=2)
    torch.cuda.synchronize()
    w = bsf.flat_weights()
    agree = means_agree(flat_stats(o_is), flat_stats(bsf))
    r_is["bsf_N200_same_chain"] = {
        "elapsed_s": time.time() - t0,
        "ess_is_fraction": bt.ess_is(w) / w.size,
        "launches": dict(ck.LAUNCHES), "plain_routes": dict(ck.PLAIN_ROUTES),
        "psi_vs_bsf": agree}
    if not agree["ok"]:
        r_is["problems"].append(f"mng_is2_psi_N10: psi disagrees with bsf "
                                f"{agree}")
    if any(ck.LAUNCHES.values()) or any(ck.PLAIN_ROUTES.values()):
        r_is["problems"].append("mng_is2_psi_N10: bsf correction launched "
                                "a kernel")
    r_da, _ = run_path(bt, ck, mng, "mng_da_psi_N10", zoo, MV_CHAINS,
                       it_mng, (), (0.05, 0.5), None, particles=10,
                       mcmc_type="da", sampling_method="psi")
    paths = [r_lg, r_is, r_da]
    for r in paths:
        mv_no_kernels(r, ck)
        r["iteration_ops"] = ops["mlg" if r is r_lg else "mng"]
        r["chain_s_per_iteration"] = r["time"]["mcmc"] / r["iter"]
    api = mv_api_phase(bt, ck, mng, zoo_mng_model(bt, torch.float32, p=1),
                       zoo_ung_model(bt, torch.float32),
                       np.log([[0.05], [0.1], [0.2], [0.4], [0.8]]))
    paths.append(api)
    return paths, [p for r in paths for p in r["problems"]]


# --------------------------------------------------------------------------
# the nonlinear models (no kernel on their paths)
# --------------------------------------------------------------------------

NLG_CHAINS = 1024
NLG_EKF_ITER = 300               # nlg_growth_ekf; both cut for the budget
NLG_ITER = 40                    # the is2 and pm paths
NLG_ROWS = 4096                  # rows of theta / replications of the checks


def growth_model(bt, dtype, y=None, **kw):
    """The JAX package's growth model at its own defaults: ``nlg_growth`` on
    ``simulate_growth()`` (n = 100, seed 0, K = 100, theta (0, log 0.05,
    0)), m = 2, k = 2, d = 3, unless ``y`` is given."""
    ex = bt.example_models
    return ex.nlg_growth(ex.simulate_growth() if y is None else y,
                         dtype=dtype, device="cuda", **kw)


def linear_nlg_series(n: int = 100, seed: int = 8) -> np.ndarray:
    """A random walk plus noise (sds 1), one missing value."""
    rng = np.random.default_rng(seed)
    y = np.cumsum(rng.normal(size=n)) + rng.normal(size=n)
    y[n // 4] = np.nan
    return y


def nlg_iteration_ops(bt, model, B: int) -> dict:
    """What paces a nonlinear chain iteration: the device operations of the
    blocks it repeats (counted by stream capture) and their eager and
    replayed milliseconds (CUDA events) at ``B`` rows of theta_init, the
    replay held to the eager call to the bit: the EKF log-likelihood
    (``ekf``'s iteration), the Gauss-Newton start, one pass and the final
    likelihood (an evaluation of approx, is2's phase 1, pm: ``passes`` of
    them, the mean over the rows), and the psi filter's estimate at N = 10
    (pm).  The growth model with forward-mode Jacobians
    (``forward_jacobian``, ``torch.func`` under capture) replays its EKF
    log-likelihood to the bit too, and equals the closed forms' within
    float32 roundoff (its eager time is not taken: ``torch.func``'s first
    use costs the host some 10 s).  ``seconds``: the host's time for a
    block's measurement."""
    from bssm_tpu_torch.inference import mcmc as tm
    from bssm_tpu_torch.inference import nlg as tn
    from bssm_tpu_torch.inference.replay import Replay
    from bssm_tpu_torch.models.nlg import forward_jacobian
    th = torch.as_tensor(model.theta_init, dtype=torch.float32,
                         device="cuda").expand(B, -1).contiguous()
    spec = model.build(th)
    mode, ok, niter = tn.nlg_mode(spec)
    gen = torch.Generator(device="cuda").manual_seed(5)
    eps = torch.randn((B, spec.n + 1, 10, spec.m), generator=gen,
                      device="cuda")
    us = torch.rand((B, spec.n, 10), generator=gen, device="cuda")
    s = spec
    auto = dataclasses.replace(spec, Z_gn=forward_jacobian(spec.Z_fn),
                               T_gn=forward_jacobian(spec.T_fn))
    blocks = {"ekf_loglik": (tn._ekf_ll, (s,)),
              "gauss_newton_start": (tn._ekf_start, (s,)),
              "gauss_newton_pass": (tn._gn_pass, (s, mode)),
              "final_loglik": (tn._final_ll, (s, mode)),
              "psi_estimate_N10": (tm._psi_states_nlg,
                                   (s, mode, eps, us, None)),
              "ekf_loglik_forward_mode": (tn._ekf_ll, (auto,))}
    rp = Replay()
    res = {"rows": B, "passes": float(niter.float().mean()),
           "all_converged": bool(ok.all())}
    eager = {}
    for name, (fn, args) in blocks.items():
        t0 = time.time()
        eager[name] = fn(*args)
        replayed = rp(fn, *args)
        same = all(torch.equal(a, b) for a, b in zip(eager[name], replayed))
        res[name] = {"device_ops": len(graph_nodes(lambda: fn(*args),
                                                   warm=False)),
                     "replayed_ms": time_ms(lambda: rp(fn, *args)),
                     "replay_bit_equal_to_eager": same}
        if name != "ekf_loglik_forward_mode":
            res[name]["eager_ms"] = time_ms(lambda: fn(*args), 1, 0)
        res[name]["seconds"] = time.time() - t0
        if not same:
            FAILURES.append({"what": f"nlg {name}: replay differs from the "
                                     "eager call"})
    ll = eager["ekf_loglik"][0]
    ll_auto = eager["ekf_loglik_forward_mode"][0]
    err = float(((ll_auto - ll).abs() / (1.0 + ll.abs())).max())
    res["forward_mode_vs_closed_form_max_rel_err"] = err
    if not err <= 1e-5:
        FAILURES.append({"what": "nlg: forward-mode Jacobians disagree with "
                                 "the closed forms", "err": err})
    res["device_ops_per_evaluation"] = (
        res["gauss_newton_start"]["device_ops"]
        + res["passes"] * res["gauss_newton_pass"]["device_ops"]
        + res["final_loglik"]["device_ops"])
    return res


def nlg_pm_start(bt, model, ekf_out, is2_start, rows: int = 8):
    """pm's start, which is2's start does not share: the ekf chains' draws
    of their first ``rows`` kept iterations (a pool of chains x ``rows``,
    at least iter / 2 - ``rows`` iterations before the last draws is2
    starts from), importance-resampled towards the exact posterior, one
    draw a chain (numpy seed 4): the weights are the psi estimate (N =
    100) over the EKF likelihood the ekf chain targets.  (The nonlinear
    models sample theta untransformed.)  Returns (thetas (chains, d), what
    to report: the pool, its weights' ESS fraction, the least lag, and
    each parameter's correlation over the chains with ``is2_start``)."""
    from bssm_tpu_torch.inference import nlg as tn
    chains, kept, d = ekf_out.theta.shape
    pool = torch.as_tensor(ekf_out.theta[:, :rows].reshape(-1, d),
                           dtype=torch.float32, device="cuda")
    spec = model.build(pool)
    gen = torch.Generator(device="cuda").manual_seed(4)
    lw = tn.psi_filter_nlg(spec, tn.approximate_nlg(spec), 100, gen,
                           keep_paths=False) - tn.ekf_loglik(spec)
    lw = lw.double().cpu().numpy()
    w = np.exp(np.where(np.isfinite(lw), lw - lw[np.isfinite(lw)].max(),
                        -np.inf))
    idx = np.random.default_rng(4).choice(w.size, chains, p=w / w.sum())
    start = pool.cpu().numpy()[idx]
    return start, {
        "pool": int(w.size), "kept_iterations": rows,
        "ess_fraction": float(w.sum() ** 2 / np.square(w).sum() / w.size),
        "distinct": int(np.unique(idx).size),
        "least_lag_to_is2_start": int(ekf_out.iter - ekf_out.burnin - rows),
        "corr_with_is2_start": [float(np.corrcoef(start[:, j],
                                                  is2_start[:, j])[0, 1])
                                for j in range(d)]}


def nlg_states_check(summary, full) -> dict:
    """``lg_states_check`` on an ekf run: the full draws' mean within 6
    sqrt(Vt / draws) of the summary's alphahat at every (t, j)."""
    res = lg_states_check(summary, full)
    for k in ("alphahat_154", "sd_154"):
        res.pop(k)
    res["alphahat_last"] = summary.alphahat[-1].tolist()
    res["sd_last"] = np.sqrt(np.diagonal(summary.Vt[-1])).tolist()
    return res


def linear_ulg(bt, y, dtype):
    """``nlg_linear_gaussian``'s model as the port's ``ssm_ulg``: a local
    level, H = exp(theta), R = 1, a1 = 0, P1 = 100."""
    return bt.ssm_ulg(y, Z=np.array([1.0]), H=1.0, T=np.array([[1.0]]),
                      R=np.array([[1.0]]), a1=np.zeros(1),
                      P1=100.0 * np.eye(1), init_theta=np.zeros(1),
                      update_fn=lambda th: {"H": torch.exp(th[:, :1])},
                      dtype=dtype, device="cuda")


def nlg_linear_checks(bt, ck) -> list:
    """``nlg_linear_gaussian`` (n = 100, 4096 rows of theta) against the
    Kalman kernels on the same local level built as ``ssm_ulg`` (H =
    exp(theta), R = 1, a1 = 0, P1 = 100), float64 and float32: the EKF's,
    the UKF's and the mode approximation's log-likelihoods against K6
    (``log_likelihood``) and ``ekf_fast_smoother`` against K7
    (``fast_smoother_ll``).  float64 1e-9 (1 + |ref|); float32 the
    log-likelihood 1e-5 + 2e-5 |ref| (the JAX package's kernel tests'),
    the UKF's 1e-4 (1 + |ref|) (its sigma points at sqrt(3 P) cancel in
    float32), the means 3e-4 (1 + the row's largest |ref|); every row."""
    from bssm_tpu_torch.inference import nlg as tn
    y = linear_nlg_series()
    out = []
    for dt in (torch.float64, torch.float32):
        nl = bt.example_models.nlg_linear_gaussian(y, dtype=dt,
                                                   device="cuda")
        lg = linear_ulg(bt, y, dt)
        gen = torch.Generator(device="cuda").manual_seed(17)
        th = 0.5 * torch.randn((NLG_ROWS, 1), generator=gen, device="cuda",
                               dtype=dt)
        s, g = nl.build(th), lg.build(th)
        before = dict(ck.LAUNCHES)
        ll = ck.log_likelihood(g)
        alpha, _ = ck.fast_smoother_ll(g)
        launched = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES
                    if ck.LAUNCHES[k] != before[k]}
        f64 = dt == torch.float64
        ll_tol = (lambda r: 1e-9 * (1 + r.abs())) if f64 \
            else (lambda r: 1e-5 + 2e-5 * r.abs())
        checks = {"ekf": (tn.ekf(s).logLik, ll, ll_tol),
                  "ukf": (tn.ukf(s).logLik, ll, (lambda r: 1e-9 * (
                      1 + r.abs())) if f64 else (lambda r: 1e-4 * (
                          1 + r.abs()))),
                  "approx": (tn.approximate_nlg(s).loglik, ll, ll_tol)}
        res = {"dtype": str(dt)[6:], "rows": NLG_ROWS, "n": len(y),
               "kernel_launches": launched}
        for name, (got, ref, tol) in checks.items():
            err = (got - ref).abs()
            res[name + "_max_abs_err"] = float(err.max())
            if not bool((err <= tol(ref)).all()):
                FAILURES.append({"what": f"nlg_linear {name} vs "
                                         f"log_likelihood {res['dtype']}",
                                 "max_abs_err": float(err.max())})
        fs = tn.ekf_fast_smoother(s)
        scale = 1.0 + alpha.abs().amax((1, 2), keepdim=True)
        err = ((fs - alpha).abs() / scale).max()
        res["ekf_fast_smoother_max_scaled_err"] = float(err)
        if not float(err) <= (1e-9 if f64 else 3e-4):
            FAILURES.append({"what": f"nlg_linear ekf_fast_smoother vs "
                                     f"fast_smoother_ll {res['dtype']}",
                             "err": float(err)})
        if launched != {"log_likelihood": 1, "fast_smoother_ll": 1}:
            FAILURES.append({"what": "nlg_linear: K6 / K7 not launched once "
                                     "each", "launched": launched})
        out.append(res)
    return out


def nlg_estimator_checks(bt, ck) -> dict:
    """Unbiasedness, by the likelihood the estimators estimate, over 4096
    replications at theta_init (float32): EKPF with 128 particles on
    ``nlg_linear_gaussian`` against its Kalman log-likelihood (K6 on the
    ``ssm_ulg`` twin), and psi with 64 particles against psi with 2048 on
    the growth model; each within 5 jackknife standard errors (the 2048
    runs in chunks of 1024 rows)."""
    from bssm_tpu_torch.inference import nlg as tn
    R = NLG_ROWS
    y = linear_nlg_series()
    nl = bt.example_models.nlg_linear_gaussian(y, dtype=torch.float32,
                                               device="cuda")
    th = torch.zeros((R, 1), device="cuda")
    lg = linear_ulg(bt, y, torch.float32)
    ref = float(ck.log_likelihood(lg.build(th[:1]))[0])
    gen = torch.Generator(device="cuda").manual_seed(23)
    t0 = time.time()
    ll = tn.ekpf_filter(nl.build(th), 128, gen, keep_paths=False)
    e, se = jackknife_loglik(ll)
    res = {"ekpf_N128": {"estimate": e, "jackknife_se": se,
                         "kalman_loglik": ref, "z": (e - ref) / se,
                         "seconds": time.time() - t0}}
    gm = growth_model(bt, torch.float32)
    spec = gm.build(torch.as_tensor(gm.theta_init, dtype=torch.float32,
                                    device="cuda").expand(R, -1))
    ap = tn.approximate_nlg(spec)
    t0 = time.time()
    lo = tn.psi_filter_nlg(spec, ap, 64, gen, keep_paths=False)
    parts = []
    step = min(R, 1024)
    for lo_row in range(0, R, step):
        rows = slice(lo_row, lo_row + step)
        sub = dataclasses.replace(spec, theta=spec.theta[rows])
        ap_sub = tn.NLGApprox(ap.mode[rows],
                              kalman_mv_rows(ap.approx, lo_row, step),
                              ap.scales[rows], ap.loglik[rows],
                              ap.niter[rows])
        parts.append(tn.psi_filter_nlg(sub, ap_sub, 2048, gen,
                                       keep_paths=False))
    hi = torch.cat(parts)
    (e1, s1), (e2, s2) = jackknife_loglik(lo), jackknife_loglik(hi)
    res["psi_N64_vs_N2048"] = {"N64": e1, "N64_se": s1, "N2048": e2,
                               "N2048_se": s2,
                               "z": (e1 - e2) / float(np.hypot(s1, s2)),
                               "seconds": time.time() - t0}
    for k, r in res.items():
        if not abs(r["z"]) < 5.0:
            FAILURES.append({"what": f"nlg estimator {k} biased", **r})
    return res


def kalman_mv_rows(g, lo: int, size: int):
    """Rows ``lo:lo+size`` of a batched ``MVLGSpec`` (``y`` shared)."""
    return g._replace(**{f: getattr(g, f)[lo:lo + size]
                         for f in g._fields if f != "y"})


def nlg_api_phase(bt, ck) -> dict:
    """The single-model API on the growth model at theta_init (float32),
    every kernel count read around it (all must stay 0): ``ekf``, the
    iterated EKF, ``ukf``, the smoothers, ``ekpf_filter``,
    ``bootstrap_filter``, ``particle_smoother`` (psi, bsf, ekf), every
    ``logLik`` method, ``gaussian_approx``, ``suggest_N``, and ``predict``
    (state, mean, response) of a short approx run with full output onto a
    model of 12 future points; all finite."""
    gm = growth_model(bt, torch.float32)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.time()
    lls = {"approx": bt.logLik(gm), "ekf": bt.logLik(gm, method="ekf"),
           "psi_N10": bt.logLik(gm, 10),
           "bsf_N200": bt.logLik(gm, 200, method="bsf"),
           "ekpf_N50": bt.logLik(gm, 50, method="ekf")}
    ek, iek = bt.ekf(gm), bt.ekf(gm, iekf_iter=2)
    uk = bt.ukf(gm)
    sm, fs = bt.ekf_smoother(gm), bt.ekf_fast_smoother(gm)
    ep, bs = bt.ekpf_filter(gm, 50), bt.bootstrap_filter(gm, 200)
    ps = {m: bt.particle_smoother(gm, 50, method=m)
          for m in ("psi", "bsf", "ekf")}
    ga = bt.gaussian_approx(gm)
    sug = bt.suggest_N(gm, candidates=(10, 20), replications=50)
    ap = bt.run_mcmc(gm, iter=8, mcmc_type="approx", output_type="full",
                     n_chains=64, seed=2)
    fut = growth_model(bt, torch.float32, y=np.full(12, np.nan))
    pr = {t: bt.predict(ap, fut, t, 4096, seed=3)
          for t in ("state", "mean", "response")}
    torch.cuda.synchronize()
    res = {"path": "nlg_api", "model": "nlg_growth on simulate_growth(), "
           "n=100, m=2, at theta_init, float32", "elapsed_s":
           time.time() - t0, "launches": dict(ck.LAUNCHES),
           "plain_routes": dict(ck.PLAIN_ROUTES),
           "replayed": dict(ck.REPLAYED),
           "logLik": {k: float(v[0]) for k, v in lls.items()},
           "ekf_loglik_iekf2": float(iek.logLik[0]),
           "ukf_loglik": float(uk.logLik[0]), "suggest_N": sug["N"],
           "predict_shapes": {k: list(v.shape) for k, v in pr.items()}}
    tensors = [*lls.values(), *ek, *iek, *uk, sm.alphahat, sm.Vt, fs,
               ep.alpha, ep.loglik, bs.alpha, bs.loglik,
               *(p.alphahat for p in ps.values()),
               *(p.Vt for p in ps.values()), ga.Z, ga.D, ga.T, ga.C]
    finite = all(bool(torch.isfinite(x).all()) for x in tensors) and all(
        np.isfinite(v).all() for v in pr.values()) and bool(
        np.isfinite(ap.alpha).all()) and np.isfinite(sug["sd"])
    res["finite"] = finite = bool(finite)
    res["problems"] = [] if finite else ["nlg_api: non-finite outputs"]
    shapes = {"state": [4096, 12, 2], "mean": [4096, 12, 1],
              "response": [4096, 12, 1]}
    if res["predict_shapes"] != shapes:
        res["problems"].append(f"nlg_api: predict {res['predict_shapes']}")
    mv_no_kernels(res, ck)
    return res


def nlg_section(bt, ck, it_ekf: int, it_nlg: int):
    """The nonlinear paths (``nlg_growth_ekf``, ``nlg_growth_is2_psi_N10``,
    ``nlg_growth_pm_psi_N10``) on the growth model at its JAX defaults, with
    what paces them (``nlg_iteration_ops``, the ``nlg_ops`` line), and the
    ``nlg_checks`` phase (``nlg_linear_checks``, ``nlg_estimator_checks``,
    the API).  is2 and pm start from the ekf chains' last theta and RAM
    scale; pm from draws is2 does not share (``nlg_pm_start``) with the
    same scale.  Every path has ``run_path``'s gates and no kernel count
    may rise on it; its own gates: the ekf full draws within 6 sqrt(Vt /
    draws) of the summary over the same thetas; is2's weighted means and
    those of ``post_correct`` with bsf 200 within 5 combined SEs of
    ``post_correct`` with psi 100 on the same phase-1 chain; pm's within 5
    of is2's.  ``steps_s`` of the phase's object: the section's seconds by
    step.  Returns (path objects, problems, the phase's object)."""
    t_start = time.time()
    steps, t_lap = {}, [t_start]

    def lap(name):
        torch.cuda.synchronize()
        steps[name] = time.time() - t_lap[0]
        t_lap[0] = time.time()

    gm = growth_model(bt, torch.float32)
    ops = nlg_iteration_ops(bt, gm, NLG_CHAINS)
    emit("nlg_ops", {**ops, "failures": FAILURES})
    lap("nlg_ops")
    desc = "nlg_growth on simulate_growth() (n=100, K=100, theta (0, log " \
        "0.05, 0)), m=2, k=2, d=3, float32"
    r_ek, o_ek = run_path(bt, ck, gm, "nlg_growth_ekf", desc, NLG_CHAINS,
                          it_ekf, (), (0.15, 0.6), None, warmup=2,
                          mcmc_type="ekf", output_type="full")
    # the summary output of the same theta chain: what run_mcmc's
    # output_type="summary" computes (the EKF smoother pooled by the law
    # of total variance), over the stored thetas
    from types import SimpleNamespace
    from bssm_tpu_torch.inference import mcmc as tm
    t0 = time.time()
    ah, Vt = tm._state_summary(gm, torch.as_tensor(o_ek.theta,
                                                   device="cuda"), 65536)
    torch.cuda.synchronize()
    summ = SimpleNamespace(alphahat=ah.cpu().numpy(), Vt=Vt.cpu().numpy(),
                           theta=o_ek.theta)
    r_ek["summary_s"] = time.time() - t0
    r_ek["states_check"] = nlg_states_check(summ, o_ek)
    if not r_ek["states_check"]["ok"]:
        r_ek["problems"].append(f"nlg_growth_ekf: full draws disagree with "
                                f"the summary {r_ek['states_check']}")
    o_ek.alpha = None                     # 414 MB on the host
    lap("ekf")
    # is2 resumes from the ekf chains: their last theta and adapted RAM
    # scale (a user's ``theta_init=out.last_theta(model), S=out.S``); pm
    # starts elsewhere (nlg_pm_start), so that the two runs' means are
    # independent
    resume = dict(theta_init=o_ek.last_theta(gm), S=o_ek.S)
    pm_init, pm_start = nlg_pm_start(bt, gm, o_ek, resume["theta_init"])
    lap("pm_start")
    r_is, o_is = run_path(bt, ck, gm, "nlg_growth_is2_psi_N10", desc,
                          NLG_CHAINS, it_nlg, (), (0.15, 0.35), None,
                          warmup=2, **resume, particles=10, mcmc_type="is2",
                          sampling_method="psi", corr_batch=65536)
    lap("is2")
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    corr = {}
    for label, N, method, rows in (("psi_N100", 100, "psi", 16384),
                                   ("bsf_N200", 200, "bsf", 8192)):
        t0 = time.time()
        pc = bt.post_correct(gm, o_is, N, sampling_method=method,
                             output_type="theta", corr_batch=rows, seed=2)
        torch.cuda.synchronize()
        w = pc.flat_weights()
        corr[label] = (pc, {"elapsed_s": time.time() - t0,
                            "ess_is_fraction": bt.ess_is(w) / w.size,
                            "finite": bool(np.isfinite(w).all())})
    ref = flat_stats(corr["psi_N100"][0])
    r_is["post_correct"] = {k: v[1] for k, v in corr.items()}
    r_is["post_correct"]["launches"] = dict(ck.LAUNCHES)
    r_is["post_correct"]["plain_routes"] = dict(ck.PLAIN_ROUTES)
    for label, out in (("psi_N10", o_is), ("bsf_N200", corr["bsf_N200"][0])):
        agree = means_agree(flat_stats(out), ref)
        r_is["post_correct"][f"{label}_vs_psi_N100"] = agree
        if not agree["ok"]:
            r_is["problems"].append(f"nlg_growth_is2_psi_N10: {label} "
                                    f"disagrees with psi N=100 {agree}")
    if not all(v[1]["finite"] for v in corr.values()):
        r_is["problems"].append("nlg_growth_is2_psi_N10: non-finite "
                                "post_correct weights")
    if any(ck.LAUNCHES.values()) or any(ck.PLAIN_ROUTES.values()) \
            or any(ck.REPLAYED.values()):
        r_is["problems"].append("nlg_growth_is2_psi_N10: post_correct "
                                "launched a kernel")
    del corr
    lap("post_correct")
    r_pm, o_pm = run_path(bt, ck, gm, "nlg_growth_pm_psi_N10", desc,
                          NLG_CHAINS, it_nlg, (), (0.10, 0.55), None,
                          warmup=2, theta_init=pm_init, S=o_ek.S,
                          particles=10, mcmc_type="pm",
                          sampling_method="psi")
    lap("pm")
    r_pm["start"] = pm_start
    agree = means_agree(flat_stats(o_pm), flat_stats(o_is))
    r_pm["vs_is2_psi_N10"] = agree
    if not agree["ok"]:
        r_pm["problems"].append(f"nlg_growth_pm_psi_N10: disagrees with "
                                f"is2 {agree}")
    approx_blocks = ("gauss_newton_start", "gauss_newton_pass",
                     "final_loglik", "psi_estimate_N10", "passes",
                     "device_ops_per_evaluation")
    for r, out in ((r_ek, o_ek), (r_is, o_is), (r_pm, o_pm)):
        mv_no_kernels(r, ck)
        r["iteration_ops"] = {k: ops[k] for k in (
            ("ekf_loglik",) if r is r_ek else approx_blocks)}
        r["chain_s_per_iteration"] = r["time"]["mcmc"] / r["iter"]
        r["posterior_mean"] = dict(zip(out.theta_names,
                                       out.flat_theta().mean(0).tolist()))
    paths = [r_ek, r_is, r_pm]
    t0 = time.time()
    phase = {"linear": nlg_linear_checks(bt, ck),
             "estimators": nlg_estimator_checks(bt, ck)}
    phase["seconds"] = time.time() - t0
    lap("checks")
    api = nlg_api_phase(bt, ck)
    paths.append(api)
    lap("api")
    phase["section_s"] = time.time() - t_start
    phase["steps_s"] = steps
    phase["failures"] = [f for f in FAILURES if "nlg" in f["what"]]
    return paths, [p for r in paths for p in r["problems"]], phase


# ---------------------------------------------------------------------------
# the SDE models and as_bssm
# ---------------------------------------------------------------------------

SDE_CHAINS = 1024
SDE_GBM_ITER = 500               # sde_gbm_is2_N16: the zoo row's depth
SDE_OU_ITER = 300                # the two sde_poisson_ou paths
SDE_ROWS = 4096                  # rows / replications of sde_checks
# the JAX package zoo's sde_gbm(is2) row, 128 chains x 500 iterations on
# its TPU (ZOO_r05.json), printed beside sde_gbm_is2_N16's, not gated on
ZOO_SDE = {"acceptance": 0.245, "ess_is_fraction": 0.6517}


def zoo_gbm_series() -> np.ndarray:
    """The JAX package zoo's ``sde_gbm`` series (n = 40, Poisson counts of
    a log-normal walk), its numpy draws replayed after the mng series'
    (``benchmarks/zoo_tpu.py:179-183``)."""
    rng = _zoo_draws()[0]
    return rng.poisson(np.exp(np.cumsum(rng.normal(0.02, 0.15, 40)))
                       ).astype(float)


def gbm_model(bt, dtype, device="cuda"):
    """The zoo's ``sde_gbm`` row: x0 = max(y_1, 1), L_f = 4, L_c = 2."""
    y = zoo_gbm_series()
    return bt.sde_gbm(y, x0=max(float(y[0]), 1.0), L_f=4, L_c=2,
                      dtype=dtype, device=device)


def ou_series(n: int = 100, seed: int = 13) -> np.ndarray:
    """``sde_poisson_ou``'s law at its theta_init (rho 0.5, nu 0, sigma
    0.3) from x0 = 0: exact OU transitions over unit time, Poisson counts
    of exp(x)."""
    rng = np.random.default_rng(seed)
    rho, nu, sig = 0.5, 0.0, 0.3
    a = np.exp(-rho)
    sd = sig * np.sqrt((1.0 - a * a) / (2.0 * rho))
    x, y = 0.0, np.zeros(n)
    for t in range(n):
        x = nu + (x - nu) * a + sd * rng.normal()
        y[t] = rng.poisson(np.exp(x))
    return y


def ou_model(bt, dtype):
    """``sde_poisson_ou`` at its defaults (L_f = 5, L_c = 2, x0 = 0) on
    ``ou_series``."""
    return bt.sde_poisson_ou(ou_series(), dtype=dtype, device="cuda")


def sde_iteration_ops(bt, B: int) -> dict:
    """What paces an SDE chain iteration: the device operations of its
    filters (counted by stream capture) and their eager and replayed
    milliseconds (CUDA events) at ``B`` rows of theta_init, 16 particles,
    the replay held to the eager call to the bit: the coarse filter of the
    gbm and the OU model (phase 1's evaluation), the OU fine filter (is2's
    correction, pm) and the pair from one draw (da's evaluation)."""
    from bssm_tpu_torch.inference import mcmc as tm
    from bssm_tpu_torch.inference import sde as ts
    from bssm_tpu_torch.inference.replay import Replay
    res = {"rows": B, "particles": 16}
    rp = Replay()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, model in (("gbm", gbm_model(bt, torch.float32)),
                         ("ou", ou_model(bt, torch.float32))):
        th = torch.as_tensor(model.theta_init, dtype=torch.float32,
                             device="cuda").expand(B, -1).contiguous()
        spec = model.build(th)
        seeds = ts.new_seeds(B, "cuda", gen)
        blocks = {f"{label}_coarse": (tm._sde_coarse, (spec, seeds, 16))}
        if label == "ou":
            blocks["ou_fine"] = (tm._sde_fine, (spec, seeds, 16, False))
            blocks["ou_da_pair"] = (tm._sde_states,
                                    (spec, seeds, 16, 16, None))
        for name, (fn, args) in blocks.items():
            t0 = time.time()
            eager = fn(*args)
            replayed = rp(fn, *args)
            same = all(torch.equal(a, b) for a, b in zip(eager, replayed))
            res[name] = {"device_ops": len(graph_nodes(lambda: fn(*args),
                                                       warm=False)),
                         "replayed_ms": time_ms(lambda: rp(fn, *args)),
                         "eager_ms": time_ms(lambda: fn(*args), 1, 0),
                         "replay_bit_equal_to_eager": same,
                         "seconds": time.time() - t0}
            if not same:
                FAILURES.append({"what": f"sde {name}: replay differs from "
                                         "the eager call"})
    return res


def sde_checks(bt) -> dict:
    """The SDE filters on the card: Milstein's terminal moments at L = 8
    against the exact GBM law over 65536 paths (mean and variance within 5
    standard errors, float32 paths summed in float64); the coupling, over
    ``SDE_ROWS`` replications of the gbm model at theta_init (16
    particles): coarse and fine log-likelihoods of one seed correlated
    above 0.2, and their difference's sd below 0.8 of that against
    independent seeds (the JAX package's ``tests/test_sde.py`` bounds);
    and seeded and stream mode in float64 on the card against the CPU,
    1e-10 (1 + |ref|) on the log-likelihood and the states, every row."""
    from bssm_tpu_torch.inference import sde as ts
    from bssm_tpu_torch.models import sde as msde
    res = {}
    t0 = time.time()
    R = 65536
    gm = gbm_model(bt, torch.float32)
    spec = gm.build(torch.tensor([0.05, 0.2, 1.5], device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = msde.milstein(spec, torch.ones(R, device="cuda"), 8, generator=gen,
                      theta=spec.theta.expand(R, -1)).double()
    mean, var = float(x.mean()), float(x.var())
    m4 = float(((x - mean) ** 4).mean())
    want_mean = float(np.exp(0.05))
    want_var = float(np.exp(0.1) * (np.exp(0.04) - 1.0))
    z_mean = (mean - want_mean) / np.sqrt(var / R)
    z_var = (var - want_var) / np.sqrt(max(m4 - var * var, 1e-30) / R)
    res["milstein_moments"] = {"paths": R, "L": 8, "mean": mean,
                               "exact_mean": want_mean, "z_mean": z_mean,
                               "var": var, "exact_var": want_var,
                               "z_var": z_var}
    if not (abs(z_mean) < 5 and abs(z_var) < 5):
        FAILURES.append({"what": "sde: Milstein moments off the GBM law",
                         **res["milstein_moments"]})
    # coarse and fine from one seed against independent seeds
    th = torch.as_tensor(gm.theta_init, dtype=torch.float32,
                         device="cuda").expand(SDE_ROWS, -1).contiguous()
    spec = gm.build(th)
    s1 = ts.new_seeds(SDE_ROWS, "cuda", gen)
    s2 = ts.new_seeds(SDE_ROWS, "cuda", gen)
    llc = ts.bsf_filter_sde(spec, 16, 2, True, seeds=s1, keep_paths=False)
    llf = ts.bsf_filter_sde(spec, 16, 4, True, seeds=s1, keep_paths=False)
    lli = ts.bsf_filter_sde(spec, 16, 4, True, seeds=s2, keep_paths=False)
    llc, llf, lli = (v.double().cpu().numpy() for v in (llc, llf, lli))
    r = float(np.corrcoef(llc, llf)[0, 1])
    sd_same, sd_ind = float(np.std(llf - llc)), float(np.std(lli - llc))
    res["coupling"] = {"rows": SDE_ROWS, "corr_same_seed": r,
                       "corr_independent": float(np.corrcoef(llc, lli)[0, 1]),
                       "sd_fine_minus_coarse_same_seed": sd_same,
                       "sd_fine_minus_coarse_independent": sd_ind}
    if not (r > 0.2 and sd_same < 0.8 * sd_ind):
        FAILURES.append({"what": "sde: coarse and fine filters of one seed "
                                 "not coupled", **res["coupling"]})
    # the card against the CPU in float64, seeded and stream mode
    cards = {dev: gbm_model(bt, torch.float64, dev) for dev in ("cuda", "cpu")}
    rows = torch.as_tensor(gm.theta_init, dtype=torch.float64) + 0.05 * \
        torch.randn((64, 3), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    rows[:, 2] = rows[:, 2].abs() + 0.5
    seeds = ts.new_seeds(64, "cpu", torch.Generator().manual_seed(4))
    n = cards["cpu"].extra["n"]
    dBf, us = ts.philox_draws(seeds, 16, 4, 0, n + 1, torch.float64)
    worst = {}
    for mode in ("seeded", "stream"):
        for L, couple in ((2, True), (4, False)):
            out = {}
            for dev, model in cards.items():
                sp = model.build(rows.to(dev))
                kw = dict(seeds=seeds.to(dev)) if mode == "seeded" else dict(
                    dBf=dBf.to(dev), us=us[:, 1:].to(dev))
                out[dev] = ts.bsf_filter_sde(sp, 16, L, couple, **kw)
            for name in ("loglik", "alpha"):
                got = getattr(out["cuda"], name).cpu()
                ref = getattr(out["cpu"], name)
                err = float(((got - ref).abs() / (1 + ref.abs())).max())
                worst[f"{mode}_L{L}_{name}"] = err
                if not err <= 1e-10:
                    FAILURES.append({"what": f"sde {mode} L={L} {name}: "
                                             "card against CPU", "err": err})
    res["card_vs_cpu_f64_max_rel_err"] = worst
    res["seconds"] = time.time() - t0
    return res


def sde_api_phase(bt, ck, gm) -> dict:
    """The single-model API on the gbm model at theta_init (float32), every
    kernel count read around it (all must stay 0): ``logLik`` (2 and 16
    particles), ``bootstrap_filter``, a short approx run (64 x 20) and its
    ``post_correct`` with summary and full output; the functions the JAX
    package fails on refuse the model with a ``ValueError``."""
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.time()
    lls = {"N2": bt.logLik(gm), "N16": bt.logLik(gm, 16, seed=2)}
    bf = bt.bootstrap_filter(gm, 16, seed=3)
    ap = bt.run_mcmc(gm, iter=20, mcmc_type="approx", n_chains=64, seed=2,
                     particles=16)
    pcs = {ot: bt.post_correct(gm, ap, 16, sampling_method="bsf",
                               output_type=ot) for ot in ("summary", "full")}
    refused = []
    for name, fn in (("particle_smoother",
                      lambda: bt.particle_smoother(gm, 16)),
                     ("suggest_N", lambda: bt.suggest_N(gm)),
                     ("post_correct psi", lambda: bt.post_correct(gm, ap,
                                                                  16))):
        try:
            fn()
        except ValueError:
            refused.append(name)
    torch.cuda.synchronize()
    res = {"path": "sde_api", "model": "sde_gbm on the zoo's series, n=40, "
           "L_f=4, L_c=2, at theta_init, float32",
           "elapsed_s": time.time() - t0, "launches": dict(ck.LAUNCHES),
           "plain_routes": dict(ck.PLAIN_ROUTES),
           "replayed": dict(ck.REPLAYED),
           "logLik": {k: float(v[0]) for k, v in lls.items()},
           "bootstrap_filter_loglik": float(bf.loglik[0]),
           "refused": refused, "problems": []}
    finite = all(np.isfinite(v) for v in res["logLik"].values()) and bool(
        torch.isfinite(bf.alpha).all()) and np.isfinite(
        pcs["summary"].alphahat).all() and np.isfinite(
        pcs["full"].alpha).all() and np.isfinite(pcs["full"].weights).all()
    if not finite:
        res["problems"].append("sde_api: non-finite values")
    if len(refused) != 3:
        res["problems"].append(f"sde_api: refused only {refused}")
    mv_no_kernels(res, ck)
    return res


def kfas_dicts(rng) -> dict:
    """KFAS ``SSModel`` objects as ``load_rds`` parses them (the layouts of
    ``tests/test_kfas.py``), with the port's hand-built twin of each: a
    local level with a diffuse initial state (kappa 1e4), a bivariate
    Gaussian with LDL-factored H and Q, Poisson with exposure 2, negative
    binomial with phi 3.5 in u, and a Poisson + Gaussian pair (u 4 for
    the Gaussian: phi 2).  The twins take ``(bt, dtype)``."""
    n = 100
    y = 900 + np.cumsum(rng.normal(0, 5, n)) + rng.normal(0, 10, n)
    level = dict(Z=np.ones((1, 1, 1)), H=np.full((1, 1, 1), 2.0),
                 T=np.ones((1, 1, 1)), R=np.ones((1, 1, 1)),
                 Q=np.full((1, 1, 1), 2.0), a1=np.zeros((1, 1)),
                 P1=np.zeros((1, 1)), P1inf=np.ones((1, 1)),
                 u=np.ones((n, 1)))
    counts = rng.poisson(np.exp(np.cumsum(rng.normal(0, 0.1, n)))).astype(
        float)
    y2 = rng.normal(size=(n, 2)).cumsum(axis=0)
    Hf = np.array([[2.0, 0.5], [0.5, 1.0]])
    Qf = np.array([[0.3, 0.1], [0.1, 0.2]])
    ym = np.column_stack([rng.poisson(3.0, n).astype(float),
                          rng.normal(0, 1, n)])
    eye = np.eye(2).reshape(2, 2, 1)
    one = dict(Z=np.ones(1), T=np.ones((1, 1)), a1=np.zeros(1),
               P1=np.full((1, 1), 1e4))
    r2 = np.full((1, 1), np.sqrt(2.0))
    return {
        "gaussian_diffuse": (
            dict(y=y[:, None], distribution="gaussian", **level),
            lambda bt, dt: bt.ssm_ulg(y, H=np.sqrt(2.0), R=r2, dtype=dt,
                                      device="cuda", **one)),
        "mlg_ldl": (
            dict(y=y2, Z=eye, H=Hf[:, :, None], T=eye, R=eye,
                 Q=Qf[:, :, None], a1=np.zeros((2, 1)), P1=5.0 * np.eye(2),
                 P1inf=np.zeros((2, 2)), u=np.ones((n, 2)),
                 distribution=["gaussian", "gaussian"]),
            lambda bt, dt: bt.ssm_mlg(
                y2, Z=np.eye(2), H=np.linalg.cholesky(Hf), T=np.eye(2),
                R=np.linalg.cholesky(Qf), a1=np.zeros(2),
                P1=5.0 * np.eye(2), dtype=dt, device="cuda")),
        "poisson_exposure": (
            dict(y=counts[:, None], distribution="poisson",
                 **{**level, "u": np.full((n, 1), 2.0)}),
            lambda bt, dt: bt.ssm_ung(counts, R=r2, distribution="poisson",
                                      u=np.full(n, 2.0), dtype=dt,
                                      device="cuda", **one)),
        "negbin_phi": (
            dict(y=counts[:, None], distribution="negative binomial",
                 **{**level, "u": np.full((n, 1), 3.5)}),
            lambda bt, dt: bt.ssm_ung(counts, R=r2,
                                      distribution="negative binomial",
                                      phi=3.5, dtype=dt, device="cuda",
                                      **one)),
        "mng_mixed": (
            dict(y=ym, Z=eye, H=np.zeros((2, 2, 1)), T=eye, R=eye,
                 Q=(0.1 * np.eye(2))[:, :, None], a1=np.zeros((2, 1)),
                 P1=np.eye(2), P1inf=np.zeros((2, 2)),
                 u=np.column_stack([np.ones(n), np.full(n, 4.0)]),
                 distribution=["poisson", "gaussian"]),
            lambda bt, dt: bt.ssm_mng(
                ym, Z=np.eye(2), T=np.eye(2), R=np.sqrt(0.1) * np.eye(2),
                distributions=["poisson", "gaussian"], phi=[1.0, 2.0],
                a1=np.zeros(2), P1=np.eye(2), dtype=dt, device="cuda"))}


def kfas_section(bt, ck) -> tuple:
    """``as_bssm`` on the card: the model of each ``kfas_dicts`` layout
    against its hand-built twin, the same kind and ``logLik`` within 1e-9
    (1 + |ref|) in float64 (exact for lg / mlg, the approximation's, by
    the single-model solve, for ng / mng: roundoff); then one short run
    each, float32, of the diffuse local level as ``ssm_ulg`` with H and R
    from ``update_fn`` (gaussian, K6) and of the Poisson one as
    ``ssm_ung`` with R from ``update_fn`` (is2/psi N = 10, K1-K3), 1024 x
    100.  Returns (the ``kfas_api`` object, its runs' path objects)."""
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.time()
    layouts = kfas_dicts(np.random.default_rng(42))
    lls, problems = {}, []
    for name, (d, twin) in layouts.items():
        m = bt.as_bssm(d, kappa=1e4, dtype=torch.float64, device="cuda")
        h = twin(bt, torch.float64)
        got, ref = (float(bt.logLik(x).reshape(-1)[0]) for x in (m, h))
        err = abs(got - ref) / (1.0 + abs(ref))
        lls[name] = {"kind": m.kind, "logLik": got, "hand_built": ref,
                     "rel_err": err}
        if m.kind != h.kind or not err <= 1e-9:
            problems.append(f"kfas_api: {name} differs from its hand-built "
                            f"model {lls[name]}")
    torch.cuda.synchronize()
    api = {"path": "kfas_api", "model": "as_bssm of five KFAS SSModel "
           "layouts, n=100, float64", "elapsed_s": time.time() - t0,
           "launches": dict(ck.LAUNCHES), "plain_routes":
           dict(ck.PLAIN_ROUTES), "replayed": dict(ck.REPLAYED),
           "logLik": lls, "problems": problems}
    if not any(api["launches"].values()):
        problems.append("kfas_api: no kernel launched")
    gauss = layouts["gaussian_diffuse"][0]
    ulg = bt.as_bssm(gauss, kappa=1e4, init_theta=np.log([np.sqrt(2.0)] * 2),
                     update_fn=lambda th: {"H": torch.exp(th[:, :1]),
                                           "R": torch.exp(th[:, 1])[
                                               :, None, None, None]},
                     prior_fn=lambda th: -0.5 * ((th - 2.0) ** 2).sum(-1),
                     theta_names=("log_H", "log_R"), dtype=torch.float32,
                     device="cuda")
    ung = bt.as_bssm(layouts["poisson_exposure"][0], kappa=1e4,
                     init_theta=[np.log(0.1)],
                     update_fn=lambda th: {"R": torch.exp(th[:, 0])[
                         :, None, None, None]},
                     prior_fn=lambda th: th[:, 0] - 0.5 * torch.exp(
                         th[:, 0]) ** 2,
                     theta_names=("log_R",), dtype=torch.float32,
                     device="cuda")
    runs = [run_path(bt, ck, ulg, "kfas_ulg_gaussian",
                     "as_bssm local level (diffuse P1, kappa 1e4), H and R "
                     "from update_fn, n=100, d=2, float32", SDE_CHAINS, 100,
                     ("log_likelihood",), (0.1, 0.7), None, warmup=5),
            run_path(bt, ck, ung, "kfas_ung_is2_psi_N10",
                     "as_bssm Poisson local level, exposure 2, R from "
                     "update_fn, n=100, d=1, float32", SDE_CHAINS, 100,
                     ("laplace_solve", "rts_factors", "psi_logw"),
                     (0.1, 0.7), 0.9, warmup=5, particles=10,
                     sampling_method="psi", corr_batch=16384)]
    return api, [r for r, _ in runs]


def sde_section(bt, ck, it_gbm: int, it_ou: int):
    """The SDE paths, each 1024 chains, float32, no kernel (every count
    must stay 0): ``sde_gbm_is2_N16`` (the zoo's row, is2/bsf N = 16;
    acceptance and ESS_IS beside the zoo's; its weighted means within 4
    SEs of the paired difference of its ``post_correct`` at N = 128 from
    the same seeds, which catches a fault in the correction that depends
    on N and not one that moves both alike),
    ``sde_poisson_ou_da_N16`` and ``sde_poisson_ou_is2_N16`` (from seeds 1
    and 2; da's and is2's means within 4 combined SEs; da's first and
    second stage acceptance), with what paces them (``sde_ops``), the
    ``sde_checks`` phase, ``sde_api`` and ``as_bssm`` (``kfas_section``,
    whose runs launch K6 and K1-K3).  ``steps_s``: the section's seconds
    by step.  Returns (path objects, problems, the phase's object)."""
    t_start = time.time()
    steps, t_lap = {}, [t_start]

    def lap(name):
        torch.cuda.synchronize()
        steps[name] = time.time() - t_lap[0]
        t_lap[0] = time.time()

    ops = sde_iteration_ops(bt, SDE_CHAINS)
    emit("sde_ops", {**ops, "failures": FAILURES})
    lap("sde_ops")
    gm = gbm_model(bt, torch.float32)
    r_g, o_g = run_path(bt, ck, gm, "sde_gbm_is2_N16", "sde_gbm on the JAX "
                        "package zoo's series (n=40, x0=max(y1, 1)), L_f=4, "
                        "L_c=2, d=3, float32", SDE_CHAINS, it_gbm, (),
                        (0.05, 0.5), None, warmup=2, particles=16,
                        mcmc_type="is2", corr_batch=16384)
    r_g["zoo_128x500"] = ZOO_SDE
    lap("gbm_is2")
    t0 = time.time()
    pc = bt.post_correct(gm, o_g, 128, sampling_method="bsf",
                         output_type="theta", corr_batch=8192)
    torch.cuda.synchronize()
    w = pc.flat_weights()
    agree = paired_means_agree(o_g, pc, k=4.0)
    r_g["post_correct_N128"] = {"elapsed_s": time.time() - t0,
                                "ess_is_fraction": bt.ess_is(w) / w.size,
                                "N16_vs_N128": agree}
    if not agree["ok"]:
        r_g["problems"].append(f"sde_gbm_is2_N16: disagrees with "
                               f"post_correct N=128 {agree}")
    del pc
    lap("gbm_post_correct")
    om = ou_model(bt, torch.float32)
    desc = "sde_poisson_ou at its defaults (L_f=5, L_c=2, x0=0) on a " \
        "series of its law at theta_init (n=100, numpy seed 13), d=3, " \
        "float32"
    r_da, o_da = run_path(bt, ck, om, "sde_poisson_ou_da_N16", desc,
                          SDE_CHAINS, it_ou, (), (0.03, 0.5), None, warmup=2,
                          particles=16, mcmc_type="da", seed=1)
    r_da["stage1_acceptance_rate"] = o_da.stage1_acceptance_rate
    r_da["stage2_acceptance_rate"] = (o_da.acceptance_rate
                                      / o_da.stage1_acceptance_rate)
    lap("ou_da")
    r_is, o_is = run_path(bt, ck, om, "sde_poisson_ou_is2_N16", desc,
                          SDE_CHAINS, it_ou, (), (0.05, 0.5), None, warmup=2,
                          particles=16, mcmc_type="is2", seed=2,
                          corr_batch=16384)
    agree = means_agree(flat_stats(o_da), flat_stats(o_is), k=4.0)
    r_da["vs_is2"] = agree
    if not agree["ok"]:
        r_da["problems"].append(f"sde_poisson_ou_da_N16: disagrees with "
                                f"is2 {agree}")
    lap("ou_is2")
    for r, out in ((r_g, o_g), (r_da, o_da), (r_is, o_is)):
        mv_no_kernels(r, ck)
        r["chain_s_per_iteration"] = r["time"]["mcmc"] / r["iter"]
        r["posterior_mean"] = dict(zip(out.theta_names,
                                       out.flat_theta().mean(0).tolist()))
    phase = {"checks": sde_checks(bt)}
    lap("checks")
    api = sde_api_phase(bt, ck, gm)
    lap("api")
    kfas, kfas_runs = kfas_section(bt, ck)
    lap("kfas")
    paths = [r_g, r_da, r_is, api, kfas] + kfas_runs
    phase["section_s"] = time.time() - t_start
    phase["steps_s"] = steps
    phase["failures"] = [f for f in FAILURES if "sde" in f["what"]]
    return paths, [p for r in paths for p in r["problems"]], phase


# ---------------------------------------------------------------------------
# the time-parallel Kalman option (core.config.parallel_time, ops/pkalman.py)
# ---------------------------------------------------------------------------

TP_ITER = 500          # psi_N10_tp and svm_is2_N64_tp, and their twins:
TP_SV_ITER = 300       # cut from 1000 for the section's budget
TP_GRID_N = (512, 4096, 16384)
TP_GRID_B = (1, 8, 64)
# The scan's float32 mode against K1's: both stop once a row's mean squared
# change falls below 50 eps (an RMS change of 2.4e-3), so two rows that stop
# a pass apart differ by about the last change or less; a fault in the scan
# moves a mode by O(1).  99% of the entries within 1e-3 (1 + |K1|), all
# within 0.5, as ``compare`` holds float32 kernels.
TP_MODE_TOL = 1e-3
# every entry of a float32 mode (scan or K1) within 1e-2 (1 + |ref|) of the
# float64 K1 mode of the same inputs (the same stopping rule, at 1e-8 in
# float64)
TP_GRID_MODE_TOL = 1e-2
TP_PROFILE_DIR = "chiprun_out/tp_profile"


@contextlib.contextmanager
def tp_only_scans(label: str):
    """The block under ``parallel_time()``; it must launch neither Laplace
    kernel (``laplace_solve``, ``laplace_step``) and take no plain route."""
    from bssm_tpu_torch.core import config
    from bssm_tpu_torch.ops import cuda_kalman as ck
    l0, p0 = dict(ck.LAUNCHES), dict(ck.PLAIN_ROUTES)
    with config.parallel_time():
        yield
    rise = {k: ck.LAUNCHES[k] - l0[k] for k in ("laplace_solve",
                                                 "laplace_step")}
    plain = {k: v - p0[k] for k, v in ck.PLAIN_ROUTES.items() if v != p0[k]}
    if any(rise.values()) or plain:
        FAILURES.append({"what": f"{label}: a Laplace kernel or a plain "
                                 "route under parallel_time()",
                         "launches": rise, "plain_routes": plain})


def _tp_ll(spec):
    from bssm_tpu_torch.ops import pkalman
    return (pkalman.log_likelihood_parallel(spec),)


def _f64(g):
    return g._replace(**{k: v.double() for k, v in g._asdict().items()})


def _row_tol(ref: torch.Tensor, tol: float) -> torch.Tensor:
    """tol (1 + the row's largest |ref|), broadcast over the row."""
    scale = ref.double().abs().flatten(1).max(1).values
    return (tol * (1.0 + scale)).view((-1,) + (1,) * (ref.dim() - 1))


def tp_checks(bt) -> list:
    """The time-parallel Laplace solve (``approximate`` under
    ``parallel_time()``, each pass a replayed CUDA graph) against K1 at the
    main path's shape (n = 153, m = 2, 4096 rows) and ``svm_is2_N64``'s
    (n = 945, m = 1, 2048 rows), float32: modes (``TP_MODE_TOL``), the
    Gaussian log-likelihood of the last pass (``F32_TOL["ll"]``, as K1
    against its plain version), the share of rows that stop at K1's pass;
    both timed.  Then on the approximating model of that solution
    ``kfilter_parallel`` and ``fast_smoother_parallel`` in float32 against
    the float64 sequential plain versions on the card: the moments and
    smoothed means within 3e-4 (1 + the row's largest |ref|) and the
    log-likelihood within 1e-5 + 2e-5 |ref|, the float32 tolerances of the
    sequential kernels K6 / K7 (the JAX package's tests/test_pallas.py).
    The scan's elements are not in Joseph form; this is where float32
    would show it."""
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.inference.replay import Replay
    from bssm_tpu_torch.ops import cuda_kalman as ck
    from bssm_tpu_torch.ops import kalman, pkalman
    conv_tol = 50.0 * float(torch.finfo(torch.float32).eps)
    runs = []
    for label, model, B, spread in (
            ("main f32 B=4096 n=153", main_path_model(bt, torch.float32),
             CHAINS, 0.5),
            ("svm f32 B=2048 n=945", svm_model(bt, torch.float32),
             CHAINS // 2, SV_SPREAD)):
        spec = model.build(thetas_around_init(model, B, 7, spread))
        mode0 = spec.initial_mode
        k_mode, _, k_niter, _, k_ll = ck.laplace_solve(spec, mode0,
                                                       conv_tol, 100)
        replay = Replay()

        def solve():
            return amod.approximate(spec, conv_tol, 100, replay=replay)
        with tp_only_scans(f"tp_checks {label}"):
            ap = solve()
            ms = time_ms(solve, reps=3, warmup=1)
        same = ap.niter == k_niter
        r = {"label": label, "B": B, "n": spec.n, "m": spec.m,
             "checks": [compare("tp mode vs laplace_solve", ap.mode, k_mode,
                                TP_MODE_TOL, False),
                        compare("tp gloglik vs laplace_solve", ap.gloglik,
                                k_ll, F32_TOL["ll"], False)],
             "same_niter_share": float(same.double().mean()),
             "niter_mean": float(ap.niter.double().mean()),
             "niter_mean_laplace_solve": float(k_niter.double().mean()),
             "ms": ms, "ms_laplace_solve": time_ms(
                 lambda: ck.laplace_solve(spec, mode0, conv_tol, 100))}
        g = ap.gaussian(spec)
        g64 = _f64(g)
        pf = pkalman.kfilter_parallel(g)
        alpha = pkalman.fast_smoother_parallel(g)
        sf = kalman.kfilter(g64)
        s_alpha = kalman.fast_smoother_ll(g64)[0]
        for name, got, ref in (("att", pf.att, sf.att),
                               ("Ptt", pf.Ptt, sf.Ptt),
                               ("at", pf.at, sf.at[:, :-1]),
                               ("Pt", pf.Pt, sf.Pt[:, :-1]),
                               ("fast_smoother_parallel", alpha, s_alpha)):
            r["checks"].append(compare_lg(
                f"{name} f32 vs f64 sequential ({label})", got, ref,
                _row_tol(ref, 3e-4), 0.0))
        r["checks"].append(compare_lg(
            f"kfilter_parallel.logLik f32 vs f64 sequential ({label})",
            pf.logLik, sf.logLik, 1e-5, 2e-5))
        runs.append(r)
        del pf, alpha, sf, s_alpha
        torch.cuda.empty_cache()
    return runs


def tp_grid(bt) -> list:
    """The same Poisson level + slope model on bench.py's series recipe at
    n in ``TP_GRID_N``, float32, B in ``TP_GRID_B`` thetas: per cell the
    Kalman log-likelihood of the approximating model (the scan's solution)
    by K6 and by ``log_likelihood_parallel`` replayed as one CUDA graph,
    and the Laplace solve by K1 and under ``parallel_time()`` (each pass
    replayed), milliseconds by CUDA events; every float32 value against
    float64 K6 / K1 on the same inputs (log-likelihood 1e-5 + 2e-5 |ref|,
    modes ``TP_GRID_MODE_TOL``)."""
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.inference.replay import Replay
    from bssm_tpu_torch.ops import cuda_kalman as ck
    conv_tol = 50.0 * float(torch.finfo(torch.float32).eps)
    cells = []
    for n in TP_GRID_N:
        m32 = main_path_model(bt, torch.float32, n=n)
        m64 = main_path_model(bt, torch.float64, n=n)
        for B in TP_GRID_B:
            label = f"tp_grid n={n} B={B}"
            th = thetas_around_init(m64, B, 11, 0.5)
            spec, spec64 = m32.build(th.float()), m64.build(th)
            mode0 = spec.initial_mode
            replay = Replay()

            def solve():
                return amod.approximate(spec, conv_tol, 100, replay=replay)

            def k1():
                return ck.laplace_solve(spec, mode0, conv_tol, 100)
            k_mode, _, k_niter, _, _ = k1()
            r_mode, _, r_niter, _, _ = ck.laplace_solve(
                spec64, spec64.initial_mode, 1e-8, 100)
            with tp_only_scans(label):
                ap = solve()
                g = ap.gaussian(spec)
                par_ll = replay(_tp_ll, g)[0]
                t = {"solve_ms": time_ms(solve, reps=3, warmup=1),
                     "ll_ms": time_ms(lambda: replay(_tp_ll, g))}
            t["solve_ms_laplace_solve"] = time_ms(k1, reps=3, warmup=1)
            t["ll_ms_log_likelihood"] = time_ms(lambda: ck.log_likelihood(g))
            ref_ll = ck.log_likelihood(_f64(g))
            mode_tol = TP_GRID_MODE_TOL * (1.0 + r_mode.double().abs())
            cell = {"n": n, "B": B, "niter_mean": float(
                        ap.niter.double().mean()),
                    "niter_mean_laplace_solve": float(
                        k_niter.double().mean()),
                    "niter_mean_f64": float(r_niter.double().mean()),
                    **t,
                    "checks": [
                        compare_lg(f"{label} tp mode vs f64", ap.mode, r_mode,
                                   mode_tol, 0.0),
                        compare_lg(f"{label} log_likelihood_parallel vs f64",
                                   par_ll, ref_ll, 1e-5, 2e-5)],
                    "laplace_solve_mode_max_abs_err_vs_f64": float(
                        (k_mode.double() - r_mode).abs().max()),
                    "log_likelihood_max_abs_err_vs_f64": float(
                        (ck.log_likelihood(g).double() - ref_ll).abs()
                        .max())}
            cells.append(cell)
            del replay, ap, g
        torch.cuda.empty_cache()
    return cells


def tp_api(bt) -> dict:
    """The single-model API on the main path's model at ``theta_init``,
    float64, under ``parallel_time()`` against the same calls without it
    (the single-model solve is K8 there): ``logLik`` (approximate, and psi
    with 10 particles from one seed), ``gaussian_approx``, ``smoother`` and
    ``importance_sample`` (64 draws, one seed), each within 1e-8 (1 + |ref|)
    at every entry: both reach the same fixed point, to roundoff in
    float64."""
    m64 = main_path_model(bt, torch.float64)

    def calls():
        g = bt.gaussian_approx(m64)
        sm = bt.smoother(m64)
        imp = bt.importance_sample(m64, 64, seed=5)
        return {"logLik": bt.logLik(m64),
                "logLik_psi10": bt.logLik(m64, 10, seed=3),
                "gaussian_approx.y": g.y, "gaussian_approx.H": g.H,
                "smoother.alphahat": sm.alphahat, "smoother.Vt": sm.Vt,
                "importance_sample.alpha": imp.alpha,
                "importance_sample.weights": imp.weights,
                "importance_sample.loglik": imp.loglik}
    t0 = time.time()
    seq = calls()
    with tp_only_scans("tp_api"):
        par = calls()
    torch.cuda.synchronize()
    return {"elapsed_s": time.time() - t0,
            "checks": [compare(f"tp_api {k}", par[k], seq[k], 1e-8, True)
                       for k in seq]}


def tp_profile(bt, model, phase) -> dict:
    """``diagnostics.profiling.profile_trace`` around one ``logLik`` of the
    main path's model under ``parallel_time()`` (the single-model solve by
    scans, eager): the Chrome trace must exist and hold CUDA kernels."""
    import glob
    import shutil
    from bssm_tpu_torch.diagnostics.profiling import profile_trace
    shutil.rmtree(TP_PROFILE_DIR, ignore_errors=True)
    with tp_only_scans("tp_profile"), profile_trace(TP_PROFILE_DIR):
        phase.sync(bt.logLik(model))
    files = sorted(glob.glob(f"{TP_PROFILE_DIR}/*.json"))
    kernels = {}
    if files:
        with open(files[0]) as f:
            for e in json.load(f)["traceEvents"]:
                if e.get("cat") == "kernel":
                    name = e.get("name", "")[:60]
                    kernels[name] = kernels.get(name, 0) + 1
    res = {"files": files, "bytes": [os.path.getsize(f) for f in files],
           "kernel_events": sum(kernels.values()),
           "top_kernels": sorted(kernels.items(), key=lambda kv: -kv[1])[:8],
           "ok": len(files) == 1 and sum(kernels.values()) > 0}
    if not res["ok"]:
        FAILURES.append({"what": "tp_profile: no trace with CUDA kernels",
                         **res})
    return res


def tp_section(bt, ck, it_main: int, it_sv: int, is2: dict):
    """The time-parallel option on the card: ``tp_checks``, ``tp_grid``,
    the paths ``psi_N10_tp`` (4096 chains, is2/psi N = 10) and
    ``svm_is2_N64_tp`` (2048 chains, N = 64, period 4) under
    ``parallel_time()`` at ``it_main`` / ``it_sv`` iterations, each gated
    as ``psi_N10`` / ``svm_is2_N64`` are (acceptance band, ESS_IS floor),
    on zero Laplace kernel launches and plain routes, and on its weighted
    means within 5 combined SEs of its sequential twin's (``_tp_twin``:
    the same run without the flag, at the same depth and seed: at another
    depth the slowly mixing SV chains differ by their burn-in, not by MC
    error), then ``tp_api`` and ``tp_profile``.  Phases timed by
    ``diagnostics.profiling.PhaseTimer``.  Returns (path objects,
    problems, the section's object)."""
    from bssm_tpu_torch.core import config
    from bssm_tpu_torch.diagnostics.profiling import PhaseTimer
    timer = PhaseTimer()
    phase = {}
    n_failures = len(FAILURES)
    with timer("tp_checks"):
        phase["checks"] = tp_checks(bt)
    with timer("tp_grid"):
        phase["grid"] = tp_grid(bt)
    m32 = main_path_model(bt, torch.float32)
    twins = {
        "psi_N10": (m32, "bsm_ng poisson level+slope, n=153, m=2, d=2, "
                    "float32", CHAINS, it_main, (0.15, 0.35), 0.95,
                    ("rts_factors", "psi_logw"), dict(particles=10, **is2)),
        "svm_is2_N64": (svm_model(bt, torch.float32), "svm sigma type, "
                        "simulated n=945, m=1, d=3, float32", CHAINS // 2,
                        it_sv, (0.10, 0.65), 0.9,
                        ("rts_factors", "psi_big_logw"),
                        dict(particles=64, psi_resample_every=4,
                             **{**is2, "corr_batch": 8192}))}
    paths = []
    for name, (model, desc, chains, it, acc, ess, req, kw) in twins.items():
        twin = name + "_tp_twin"
        with timer(twin):
            r, seq = run_path(bt, ck, model, twin, desc, chains, it,
                              ("laplace_solve",) + req, acc, ess, **kw)
        paths.append(r)
        label = name + "_tp"
        with timer(label):
            with config.parallel_time():
                r, out = run_path(bt, ck, model, label, desc, chains, it,
                                  req, acc, ess, **kw)
        for k in ("laplace_solve", "laplace_step"):
            if r["launches"][k]:
                r["problems"].append(f"{label}: {k} launched "
                                     f"{r['launches'][k]} times")
        agree = means_agree(flat_stats(out), flat_stats(seq), k=5.0)
        r["vs_sequential"] = agree
        if not agree["ok"]:
            r["problems"].append(f"{label}: disagrees with {twin} {agree}")
        r["chain_s_per_iteration"] = r["time"]["mcmc"] / r["iter"]
        paths.append(r)
        del out, seq
    with timer("tp_api"):
        phase["api"] = tp_api(bt)
    with timer("tp_profile") as ph:
        phase["profile"] = tp_profile(bt, m32, ph)
    phase["steps_s"] = timer.report()
    phase["section_s"] = timer.total
    phase["failures"] = FAILURES[n_failures:]
    return paths, [p for r in paths for p in r["problems"]], phase


# ---------------------------------------------------------------------------
# the mesh (parallel/): run_mcmc(mesh=...) over torch.distributed
# ---------------------------------------------------------------------------

MESH_ITER = 200        # the two 4096-chain runs; cut from 1000 for the
MESH_SHORT_ITER = 100  # section's 60 s; the two 1024-chain runs
MESH_RANKS = 2
MESH_TIMEOUT = 600     # seconds the two ranks may take
# the fields a rank saves: per row bit for bit, the rest summed
MESH_ROW_FIELDS = ("theta", "accepted", "posterior", "weights", "S")


def mesh_runs(bt) -> dict:
    """The runs of the mesh section, ``label: (model, run_mcmc kwargs)``,
    at the full widths of their paths: ``psi_N10``'s model and run
    (K1-K3), ``lg_theta``'s (K6), ``pm_bsf_N200``'s (K5 in Philox mode)
    and ``psi_N256``'s at period 8 (K4 in Philox mode); only iterations
    cut."""
    m32 = main_path_model(bt, torch.float32)
    is2 = dict(mcmc_type="is2", sampling_method="psi", store_modes=False,
               corr_batch=16384, output_type="theta", seed=1)
    return {
        "psi_N10": (m32, dict(iter=MESH_ITER, n_chains=CHAINS,
                              particles=10, **is2)),
        "lg_theta": (airquality_model(bt, torch.float32),
                     dict(iter=MESH_ITER, n_chains=CHAINS,
                          output_type="theta", seed=1)),
        "pm_bsf_N200": (calm_model(bt, torch.float32),
                        dict(iter=MESH_SHORT_ITER, n_chains=CHAINS // 4,
                             particles=200, mcmc_type="pm",
                             sampling_method="bsf", output_type="theta",
                             seed=1)),
        "psi_N256": (m32, dict(iter=MESH_SHORT_ITER, n_chains=CHAINS // 4,
                               particles=256, psi_resample_every=8, **is2))}



MESH_REQUIRED = {"psi_N10": ("laplace_solve", "rts_factors", "psi_logw"),
                 "lg_theta": ("log_likelihood",),
                 "pm_bsf_N200": ("bsf_big_logw",),
                 "psi_N256": ("laplace_solve", "rts_factors",
                              "psi_big_logw")}


def mesh_fields(out) -> dict:
    """An output's per-row fields (those it has) and acceptance rate, as
    numpy."""
    f = {k: getattr(out, k) for k in MESH_ROW_FIELDS
         if getattr(out, k) is not None}
    f["acceptance_rate"] = np.asarray(out.acceptance_rate)
    return f


def mesh_compare(got: dict, want: dict, gap: dict = None) -> dict:
    """``got`` against ``want`` (``mesh_fields``): every per-row field bit
    for bit (NaN equal to NaN); the weighted posterior means, a sum, within
    ``gap``, the largest difference two unsharded runs of one seed showed
    (or bit for bit when there is none)."""
    res = {"bit_equal": {}, "problems": []}
    for k in MESH_ROW_FIELDS + ("acceptance_rate",):
        if (k in got) != (k in want):
            res["problems"].append(f"{k} present on one side only")
            continue
        if k not in want:
            continue
        same = got[k].shape == want[k].shape and bool(np.array_equal(
            got[k], want[k], equal_nan=got[k].dtype.kind == "f"))
        res["bit_equal"][k] = same
        if not same:
            d = np.abs(got[k].astype(float) - want[k].astype(float))
            res["problems"].append(
                f"{k} differs: {int((d > 0).sum())} entries, largest "
                f"{float(np.nanmax(d))}" if got[k].shape == want[k].shape
                else f"{k} shape {got[k].shape} vs {want[k].shape}")

    def means(f):
        w = f["weights"].reshape(-1) if "weights" in f \
            else np.ones(f["theta"].shape[0] * f["theta"].shape[1])
        th = f["theta"].reshape(-1, f["theta"].shape[-1]).astype(float)
        return (w[:, None] * th).sum(0) / w.sum()

    diff = float(np.abs(means(got) - means(want)).max())
    res["weighted_mean_diff"] = diff
    allowed = 0.0 if gap is None else gap["weighted_mean_diff"]
    res["allowed"] = allowed
    if diff > allowed:
        res["problems"].append(f"weighted means differ by {diff} > {allowed}")
    return res


def mesh_rank(args) -> int:
    """One rank of the section's two-rank run, in a process of its own
    (``--mesh-rank``): gloo (NCCL refuses two ranks on one device) over
    ``--mesh-port``, the one card, every run of ``mesh_runs`` with
    ``mesh=``; saves each run's gathered output and the launch and
    plain-route counts of that run (set to 0 just before it) under
    ``--mesh-out``."""
    import bssm_tpu_torch as bt
    from bssm_tpu_torch.ops import cuda_kalman as ck
    from bssm_tpu_torch.parallel.distributed import initialize
    torch.cuda.set_device(0)
    rank = int(args.mesh_rank)
    if not initialize(f"127.0.0.1:{args.mesh_port}", MESH_RANKS, rank,
                      backend="gloo"):
        raise RuntimeError("no process group")
    mesh = bt.make_mesh()
    info = {"backend": torch.distributed.get_backend(),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "device": str(torch.cuda.current_device()), "runs": {}}
    for label, (model, kw) in mesh_runs(bt).items():
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.time()
        out = bt.run_mcmc(model, mesh=mesh, **kw)
        torch.cuda.synchronize()
        info["runs"][label] = {"elapsed_s": time.time() - t0,
                               "time": out.time,
                               "launches": dict(ck.LAUNCHES),
                               "plain_routes": dict(ck.PLAIN_ROUTES)}
        np.savez(os.path.join(args.mesh_out, f"rank{rank}_{label}.npz"),
                 **mesh_fields(out))
    with open(os.path.join(args.mesh_out, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()
    return 0


def mesh_section(bt, ck) -> tuple:
    """``run_mcmc(mesh=...)`` on the card (``parallel/``).  Run 1, a world
    of one (NCCL, ``make_mesh()`` with no process group): ``psi_N10``'s run
    at 4096 chains x ``MESH_ITER`` with the mesh against two runs without
    it, the same seed.  Run 2, two ranks on the one card in processes of
    their own (``mesh_rank``: gloo, whose collectives go through host
    memory, 2048 chains each on ``psi_N10``'s and ``lg_theta``'s runs, 512
    on ``pm_bsf_N200``'s and ``psi_N256``'s): every rank's gathered output
    against this process's run without a mesh.  Gates: thetas, acceptance
    flags, posteriors, weights and RAM factors bit for bit, the weighted
    means within the gap of the two unsharded runs; the path's kernels
    launched in that run (the ranks: K4, K5 in Philox mode with their row
    offsets) and no plain route.  Returns (path objects, problems, the
    section's object)."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="mesh_") as out_dir:
        return _mesh_section(bt, ck, out_dir)


def _mesh_section(bt, ck, out_dir: str) -> tuple:
    """``mesh_section`` with the ranks' outputs in ``out_dir``."""
    import socket
    import torch.distributed as dist
    t0 = time.time()
    runs = mesh_runs(bt)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # the ranks start first and run while this process runs run 1 and the
    # unsharded references; they build nothing (the library is built)
    logs = [os.path.join(out_dir, f"rank{r}.log") for r in range(MESH_RANKS)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                 str(r), "--mesh-port", str(port), "--mesh-out", out_dir],
                stdout=f, stderr=subprocess.STDOUT))
    phase = {"run1": {"backend": "nccl", "world": 1},
             "run2": {"backend": "gloo", "staging": "host", "world":
                      MESH_RANKS, "ranks_on_one_device": True}}
    problems, paths = [], []
    try:
        model, kw = runs["psi_N10"]
        bt.run_mcmc(model, **{**kw, "iter": 20})            # warm-up
        refs, seconds = {}, {}
        for tag in ("a", "b"):
            t1 = time.time()
            refs[tag] = mesh_fields(bt.run_mcmc(model, **kw))
            torch.cuda.synchronize()
            seconds["unsharded_" + tag] = time.time() - t1
        gap = mesh_compare(refs["b"], refs["a"], {"weighted_mean_diff":
                                                  float("inf")})
        phase["run1"]["unsharded_gap"] = {
            "bit_equal": gap["bit_equal"],
            "weighted_mean_diff": gap["weighted_mean_diff"]}
        mesh = bt.make_mesh()
        phase["run1"]["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        phase["run1"]["backend"] = dist.get_backend()
        # a warm-up with the mesh: NCCL sets its communicator up at the
        # first collective (1.3 s on the card)
        t1 = time.time()
        bt.run_mcmc(model, mesh=mesh, **{**kw, "iter": 20})
        torch.cuda.synchronize()
        seconds["mesh_warmup"] = time.time() - t1
        ck.reset_launch_counts()
        t1 = time.time()
        out = bt.run_mcmc(model, mesh=mesh, **kw)
        torch.cuda.synchronize()
        seconds["mesh"] = time.time() - t1
        launches, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_ROUTES)
        dist.destroy_process_group()
        cmp1 = mesh_compare(mesh_fields(out), refs["a"], gap)
        phase["run1"].update(seconds=seconds, compare=cmp1,
                             acceptance_rate=out.acceptance_rate)
        r1 = {"path": "mesh_psi_N10_nccl", "chains": kw["n_chains"],
              "iter": kw["iter"], "elapsed_s": seconds["mesh"],
              "launches": launches, "plain_routes": plain,
              "replayed": {}, "problems": []}
        r1["problems"] += [f"mesh run 1: {p}" for p in cmp1["problems"]]
        for k in MESH_REQUIRED["psi_N10"]:
            if launches[k] <= 0:
                r1["problems"].append(f"mesh run 1: {k} not launched")
        if any(plain.values()):
            r1["problems"].append(f"mesh run 1: plain routes {plain}")
        paths.append(r1)
        del out
        # run 2's references, the same runs without a mesh
        refs2 = {"psi_N10": refs["a"]}
        for label in ("lg_theta", "pm_bsf_N200", "psi_N256"):
            m, k2 = runs[label]
            t1 = time.time()
            refs2[label] = mesh_fields(bt.run_mcmc(m, **k2))
            seconds[f"unsharded_{label}"] = time.time() - t1
        for p in procs:
            p.wait(timeout=MESH_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    run2 = phase["run2"]
    run2["ranks"] = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(log) as f:
                problems.append(f"mesh rank {r} exited {p.returncode}: "
                                f"{f.read()[-3000:]}")
            continue
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            info = json.load(f)
        info["compare"] = {}
        for label, rinfo in info["runs"].items():
            with np.load(os.path.join(out_dir, f"rank{r}_{label}.npz")) as z:
                got = {k: z[k] for k in z.files}
            c = mesh_compare(got, refs2[label],
                             gap if label == "psi_N10" else None)
            info["compare"][label] = c
            problems += [f"mesh run 2 rank {r} {label}: {q}"
                         for q in c["problems"]]
            for k in MESH_REQUIRED[label]:
                if rinfo["launches"][k] <= 0:
                    problems.append(f"mesh run 2 rank {r} {label}: {k} not "
                                    "launched")
            if any(rinfo["plain_routes"].values()):
                problems.append(f"mesh run 2 rank {r} {label}: plain routes "
                                f"{rinfo['plain_routes']}")
        if info["backend"] != "gloo":
            problems.append(f"mesh rank {r}: backend {info['backend']}")
        run2["ranks"].append(info)
    phase["section_s"] = time.time() - t0
    problems += [q for r in paths for q in r["problems"]]
    return paths, problems, phase


# ---------------------------------------------------------------------------
# the JAX package's call forms on the card
# ---------------------------------------------------------------------------

API_ROWS = 4096            # spdk_sample's rows at theta_init
API_PARTICLES = 10
API_RESAMPLE = (16384, 256)            # rows x N of the resamplers
API_BUDGET_S = 30.0
# float32 slack of the resamplers' count bounds: a uniform (j + r) / N is
# rounded by some 6e-8, so a stratum boundary moves by N x 6e-8 of a count
API_COUNT_SLACK = 1e-3


def keyword_post_correct(bt, ck, m32, out):
    """``post_correct`` of ``approx_full``'s stored run by keyword with the
    run's correction generator, which replays ``is2_full``'s correction;
    launch and plain-route counts set to 0 just before and read just
    after.  Returns (output, elapsed s, launches, plain routes)."""
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.time()
    pc = bt.post_correct(m32, out, 10, is_type=2, output_type="full",
                         corr_batch=16384,
                         generator=bt.is_correction_generator(1, "cuda"))
    torch.cuda.synchronize()
    return pc, time.time() - t0, dict(ck.LAUNCHES), dict(ck.PLAIN_ROUTES)


def _array_fields(out) -> dict:
    return {f.name: getattr(out, f.name) for f in dataclasses.fields(out)
            if isinstance(getattr(out, f.name), np.ndarray)}


def _fields_equal(a, b) -> dict:
    """``{field: equal to the bit}`` over the array fields of two outputs
    (NaN equal to NaN)."""
    fa, fb = _array_fields(a), _array_fields(b)
    return {f: f in fb and fa[f].shape == fb[f].shape
            and bool(np.array_equal(fa[f], fb[f], equal_nan=True))
            for f in sorted(set(fa) | set(fb))}


def _resampler_counts(idx: torch.Tensor, w: torch.Tensor) -> dict:
    """Largest |count - N w_k| of every row's particles, against the
    strata the resampler drew over (the float32 cumulative weights, the
    last set to 1) and against the weights themselves."""
    N = w.shape[-1]
    counts = torch.zeros_like(idx).scatter_add_(-1, idx,
                                                torch.ones_like(idx))
    cp = torch.cumsum(w, -1).double()
    cp[..., -1] = 1.0
    width = torch.diff(cp, dim=-1, prepend=torch.zeros_like(cp[..., :1]))
    return {"in_range": bool((idx >= 0).all() and (idx < N).all()),
            "max_dev_strata": float((counts - N * width).abs().max()),
            "max_dev_weights": float((counts - N * w.double()).abs().max())}


def api_phase(bt, ck, m32, a32, outs, pc_kw, kw_launches) -> dict:
    """The JAX package's call forms on the card, at the main path's width.
    ``post_correct`` in the JAX positional order, (model, output, particles,
    sampling_method, is_type, seed, mesh, corr_batch, output_type,
    generator in key's place), on ``approx_full``'s stored run (1024 x
    1000, N = 10): with full output against the keyword call ``pc_kw``
    (``kw_launches`` its launches), every array field (weights, alpha,
    posterior, ...) equal to the bit, the same launches and no plain
    route; with theta output the same pair, both made here.
    ``spdk_sample`` on the main path's model at ``theta_init`` over 4096
    rows, N = 10: ``antithetic=True`` equal to the call without the flag
    from one generator seed, to the bit; ``antithetic=False``'s log mean
    likelihood within 5 combined jackknife SEs of the antithetic one's;
    K7 (``fast_smoother_ll``) launched.  ``systematic_indices`` /
    ``stratified_indices`` on 16384 rows of N = 256 random float32
    weights: every index in range, every count within 1 (systematic) / 2
    (stratified) of N times its stratum's width, for any draw.
    ``smoother(spec, want_ccov=True)`` on ``lg_theta``'s model (4096 rows
    at theta_init) equal to ``smoother(spec)`` to the bit.  The phase
    within ``API_BUDGET_S``."""
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.inference import particle as P
    from bssm_tpu_torch.ops import kalman as K
    from bssm_tpu_torch.ops import resample as RS
    t_phase = time.time()
    problems = []
    res = {"nvidia_smi": nvidia_smi_line()}
    total = {k: 0 for k in ck.LAUNCHES}

    def counted(fn):
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.time()
        r = fn()
        torch.cuda.synchronize()
        for k in total:
            total[k] += ck.LAUNCHES[k]
        return r, time.time() - t0, dict(ck.LAUNCHES), dict(ck.PLAIN_ROUTES)

    # post_correct by position
    ap = outs["approx_full"]
    pcs = {}
    for ot in ("full", "theta"):
        pos, t_pos, l_pos, p_pos = counted(lambda: bt.post_correct(
            m32, ap, 10, "psi", 2, 1, None, 16384, ot,
            bt.is_correction_generator(1, "cuda")))
        if ot == "full":
            kw, l_kw = pc_kw, kw_launches
        else:
            kw, _, l_kw, _ = counted(lambda: bt.post_correct(
                m32, ap, 10, output_type="theta", corr_batch=16384,
                generator=bt.is_correction_generator(1, "cuda")))
        eq = _fields_equal(pos, kw)
        pcs[ot] = {"elapsed_s": t_pos, "launches": l_pos,
                   "keyword_launches": l_kw, "plain_routes": p_pos,
                   "fields_equal": eq, "output_type": pos.output_type}
        if not (all(eq.values()) and "weights" in eq):
            problems.append(f"post_correct {ot}: positional differs from "
                            f"keyword {eq}")
        if (ot == "full") != ("alpha" in eq):
            problems.append(f"post_correct {ot}: output_type bound wrong")
        if l_pos != l_kw:
            problems.append(f"post_correct {ot}: launches {l_pos} != "
                            f"keyword's {l_kw}")
        need = ("rts_factors",) if ot == "full" else ("rts_factors",
                                                      "psi_logw")
        for k in need:
            if l_pos[k] <= 0:
                problems.append(f"post_correct {ot}: {k} not launched")
        if any(p_pos.values()):
            problems.append(f"post_correct {ot}: plain routes {p_pos}")
        del pos, kw
    res["post_correct"] = pcs

    # spdk_sample with the JAX keyword
    th = torch.as_tensor(m32.theta_init, dtype=m32.dtype,
                         device="cuda").expand(API_ROWS, -1)
    spec = m32.build(th)
    al = amod.approx_loglik(spec)

    def spdk(seed, **kw):
        return P.spdk_sample(spec, al, API_PARTICLES,
                             torch.Generator(device="cuda").manual_seed(seed),
                             **kw)
    r_def, _, _, _ = counted(lambda: spdk(11))
    r_on, t_on, l_on, p_on = counted(lambda: spdk(11, antithetic=True))
    r_off, t_off, l_off, p_off = counted(lambda: spdk(12, antithetic=False))
    same = all(torch.equal(a, b) for a, b in zip(r_on, r_def))
    est_on, se_on = jackknife_loglik(r_on.loglik)
    est_off, se_off = jackknife_loglik(r_off.loglik)
    z = abs(est_on - est_off) / np.hypot(se_on, se_off)
    res["spdk_sample"] = {
        "rows": API_ROWS, "particles": API_PARTICLES,
        "antithetic_equals_default": same,
        "log_mean_lik_antithetic": [est_on, se_on],
        "log_mean_lik_independent": [est_off, se_off], "z": float(z),
        "ms_antithetic": 1e3 * t_on, "ms_independent": 1e3 * t_off,
        "launches": {k: l_on[k] + l_off[k] for k in l_on},
        "plain_routes": {k: p_on[k] + p_off[k] for k in p_on}}
    if not same:
        problems.append("spdk_sample: antithetic=True differs from the "
                        "default call")
    if not z <= 5.0:
        problems.append(f"spdk_sample: antithetic=False {z} SEs away")
    if min(l_on["fast_smoother_ll"], l_off["fast_smoother_ll"]) <= 0:
        problems.append("spdk_sample: fast_smoother_ll not launched")
    if any(p_on.values()) or any(p_off.values()):
        problems.append("spdk_sample: plain routes")
    if not all(bool(torch.isfinite(r.loglik).all()) for r in (r_on, r_off)):
        problems.append("spdk_sample: non-finite log-likelihoods")
    del r_def, r_on, r_off, al, spec

    # the keyed resamplers
    B, N = API_RESAMPLE
    g = torch.Generator(device="cuda").manual_seed(21)
    w = torch.exp(1.5 * torch.randn(B, N, device="cuda", generator=g))
    w = w / w.sum(-1, keepdim=True)
    res["resamplers"] = {"rows": B, "particles": N}
    for kind, bound in (("systematic", 1.0), ("stratified", 2.0)):
        fn = getattr(RS, f"{kind}_indices")
        idx, t_r, _, _ = counted(lambda: fn(
            w, torch.Generator(device="cuda").manual_seed(5)))
        again = fn(w, torch.Generator(device="cuda").manual_seed(5))
        c = _resampler_counts(idx, w)
        c.update(bound=bound, ms=1e3 * t_r, replays=bool(torch.equal(
            idx, again)))
        res["resamplers"][kind] = c
        if not (c["in_range"] and c["replays"]
                and c["max_dev_strata"] <= bound + API_COUNT_SLACK):
            problems.append(f"{kind}_indices: {c}")

    # smoother's want_ccov
    lg = a32.build(torch.as_tensor(a32.theta_init, dtype=a32.dtype,
                                   device="cuda").expand(API_ROWS, -1))
    with_flag, t_s, _, _ = counted(lambda: K.smoother(lg, want_ccov=True))
    plain = K.smoother(lg)
    eq = [bool(torch.equal(a, b)) for a, b in zip(with_flag, plain)]
    res["smoother"] = {"rows": API_ROWS, "ms": 1e3 * t_s,
                       "fields_equal": dict(zip(with_flag._fields, eq))}
    if not all(eq):
        problems.append(f"smoother: want_ccov=True differs {eq}")
    res["launches"] = total
    res["section_s"] = time.time() - t_phase
    if not res["section_s"] <= API_BUDGET_S:
        problems.append(f"api phase took {res['section_s']} s")
    res["problems"] = [f"api: {p}" for p in problems]
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iter", type=int, default=1000,
                    help="iterations of each path (default 1000; the "
                         "pseudo-marginal and delayed-acceptance paths run "
                         "half as many)")
    ap.add_argument("--staging-sweep", action="store_true",
                    help="only time the stagings of laplace_solve, "
                         "rts_factors and fast_smoother_ll over B, m and "
                         "dtype and the layouts of laplace_step "
                         "(staging_sweep, rts_staging_sweep, "
                         "fs_staging_sweep, step_staging_readings), print "
                         "them and stop; prints no result line")
    ap.add_argument("--big-only", action="store_true",
                    help="only run the large-ensemble kernel's checks and "
                         "times (big_section) and stop; prints no result "
                         "line")
    ap.add_argument("--ab", metavar="DIR",
                    help="only the A/B of this package against the package "
                         "checked out in DIR, on one card (ab); prints no "
                         "result line")
    ap.add_argument("--ab-set", choices=sorted(AB_READINGS),
                    default="k2k3",
                    help="the readings of --ab: k2k3 (rts_factors and "
                         "psi_logw, psi_N10's phase 2, da_psi_N64's chain; "
                         "the default), big (the large-ensemble kernel "
                         "and the paths it paces) or k7k8 "
                         "(fast_smoother_ll and laplace_step, the "
                         "single-model solve, lg_full's and approx_full's "
                         "states)")
    ap.add_argument("--ab-side", choices=sorted(AB_READINGS),
                    help=argparse.SUPPRESS)
    ap.add_argument("--grid-depth", type=int, metavar="ITER",
                    help="only the replication grid at ITER iterations "
                         "(replications_phase, same gates) and the tails of "
                         "the global approximation's estimators on its "
                         "is2/psi/global draws (global_tails); prints no "
                         "result line")
    ap.add_argument("--mv-iter", type=int, default=MV_ITER,
                    help=f"iterations of the multivariate non-Gaussian "
                         f"paths (default {MV_ITER}; mlg_gaussian runs "
                         f"--iter)")
    ap.add_argument("--mv-only", action="store_true",
                    help="only the multivariate paths and phase "
                         "(mv_section) and stop; prints no result line")
    ap.add_argument("--nlg-only", action="store_true",
                    help="only the nonlinear paths and phase "
                         "(nlg_section) and stop; prints no result line")
    ap.add_argument("--sde-only", action="store_true",
                    help="only the SDE paths, their phase and as_bssm "
                         "(sde_section) and stop; prints no result line")
    ap.add_argument("--tp-only", action="store_true",
                    help="only the time-parallel section (tp_section) "
                         "and stop; prints no result line")
    ap.add_argument("--geometry-sweep", action="store_true",
                    help="only time the large-ensemble kernel under launch "
                         "geometries the rule does not pick "
                         "(geometry_sweep); prints no result line")
    ap.add_argument("--mesh-only", action="store_true",
                    help="only the mesh section (mesh_section: a world of "
                         "one over NCCL, two gloo ranks on the one card) "
                         "and stop; prints no result line")
    ap.add_argument("--api-only", action="store_true",
                    help="only approx_full (--iter iterations), its "
                         "post_correct and the api phase (api_phase) and "
                         "stop; prints no result line")
    # one rank of the mesh section's two-rank run (mesh_rank)
    ap.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", help=argparse.SUPPRESS)
    args = ap.parse_args()

    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import bssm_tpu_torch as bt
    from bssm_tpu_torch.ops import cuda_kalman as ck
    assert "jax" not in sys.modules and "bssm_tpu" not in sys.modules
    if args.mesh_rank is not None:
        return mesh_rank(args)

    smi = nvidia_smi_line()
    ck.build()
    nvcc = subprocess.run([ck._find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    emit("card", {"nvidia_smi": smi, "torch": torch.__version__,
                  "cuda": torch.version.cuda,
                  "nvcc": nvcc.stdout.strip().splitlines()[-1],
                  "build_seconds": ck.build_seconds,
                  "tf32_matmul": torch.backends.cuda.matmul.allow_tf32})
    if args.staging_sweep:
        emit("staging_sweep", {"nvidia_smi": smi, "runs": staging_sweep(bt),
                               "rts_factors": rts_staging_sweep(bt),
                               "fast_smoother_ll": fs_staging_sweep(bt),
                               "laplace_step": step_staging_readings(bt),
                               "failures": FAILURES})
        return 1 if FAILURES else 0
    if args.ab_side:
        emit("ab_side", {"nvidia_smi": smi, "build_seconds": ck.build_seconds,
                         **AB_READINGS[args.ab_side](bt)})
        return 0
    if args.ab:
        return ab(args.ab, args.ab_set, smi)
    if args.geometry_sweep:
        emit("geometry_sweep", {"nvidia_smi": smi,
                                "runs": geometry_sweep(bt),
                                "failures": FAILURES})
        return 1 if FAILURES else 0
    if args.grid_depth:
        key = ("is2", "psi", "global")
        ph = replications_phase(bt, ck, args.grid_depth, keep=(key,))
        out = ph.pop("outputs").get(key)
        if out is not None:         # float64: not an artefact of float32
            ph["global_tails"] = {
                str(dt)[6:]: global_tails(bt, replication_model(bt, dt), out)
                for dt in (torch.float32, torch.float64)}
        emit("grid_depth", {"nvidia_smi": smi, **ph})
        return 1 if ph["problems"] or out is None else 0
    if args.big_only:
        big_section(bt, main_path_model(bt, torch.float32),
                    main_path_model(bt, torch.float64))
        return 1 if FAILURES else 0
    if args.mv_only:
        mv_paths, mv_problems = mv_section(bt, ck, args.iter, args.mv_iter)
        for r in mv_paths:
            emit("path", r)
        return 1 if mv_problems or FAILURES else 0
    if args.nlg_only:
        nlg_paths, nlg_problems, nlg_phase = nlg_section(
            bt, ck, min(args.iter, NLG_EKF_ITER), min(args.iter, NLG_ITER))
        emit("nlg_checks", nlg_phase)
        for r in nlg_paths:
            emit("path", r)
        return 1 if nlg_problems or FAILURES else 0
    if args.sde_only:
        sde_paths, sde_problems, sde_phase = sde_section(
            bt, ck, min(args.iter, SDE_GBM_ITER), min(args.iter, SDE_OU_ITER))
        emit("sde_checks", sde_phase)
        for r in sde_paths:
            emit("path", r)
        return 1 if sde_problems or FAILURES else 0
    is2 = dict(mcmc_type="is2", sampling_method="psi", store_modes=False,
               corr_batch=16384)
    if args.mesh_only:
        mesh_paths, mesh_problems, mesh_phase = mesh_section(bt, ck)
        emit("mesh", mesh_phase)
        for r in mesh_paths:
            emit("path", r)
        if mesh_problems:
            print("chip_smoke: mesh section failed: "
                  + "; ".join(mesh_problems), file=sys.stderr)
        return 1 if mesh_problems else 0
    if args.api_only:
        m32 = main_path_model(bt, torch.float32)
        r_ap, o_ap = run_path(
            bt, ck, m32, "approx_full", "bsm_ng poisson level+slope, n=153, "
            "m=2, d=2, float32", CHAINS // 4, args.iter,
            ("laplace_solve", "fast_smoother_ll"), (0.15, 0.35), None,
            mcmc_type="approx", output_type="full", store_modes=True)
        pc, _, pc_launches, _ = keyword_post_correct(bt, ck, m32, o_ap)
        api = api_phase(bt, ck, m32, airquality_model(bt, torch.float32),
                        {"approx_full": o_ap}, pc, pc_launches)
        emit("path", r_ap)
        emit("api", api)
        problems = r_ap["problems"] + api["problems"]
        if problems:
            print("chip_smoke: api phase failed: " + "; ".join(problems),
                  file=sys.stderr)
        return 1 if problems else 0
    if args.tp_only:
        tp_paths, tp_problems, tp_phase = tp_section(
            bt, ck, min(args.iter, TP_ITER), min(args.iter, TP_SV_ITER), is2)
        emit("tp_checks", tp_phase)
        for r in tp_paths:
            emit("path", r)
        return 1 if tp_problems or FAILURES else 0
    # ---- kernels against their plain versions -----------------------------
    checks = []
    m32 = main_path_model(bt, torch.float32)
    m64 = main_path_model(bt, torch.float64)
    c_16k = check_kernels(m32, 16384, 10, "main f32 B=16384", timed=True)
    c_4k = check_kernels(m32, 4096, 10, "main f32 B=4096", timed=True)
    checks += [c_16k, c_4k,
               check_kernels(m64, 16384, 10, "main f64 B=16384", timed=True),
               check_kernels(m64, 4096, 10, "main f64 B=4096", timed=False),
               check_kernels(m64, 1024, 10, "main f64 B=1024", timed=False)]
    # the 1024-chain paths give K1 and K2 this batch
    c_1k = check_kernels(m32, 1024, 10, "main f32 B=1024", timed=True)
    checks.append(c_1k)
    for dtype in (torch.float64, torch.float32):
        for fam in ("svm", "binomial", "negative binomial", "gamma"):
            checks.append(check_kernels(
                sweep_model(bt, fam, 2, dtype), 256, 10, f"sweep {fam}",
                timed=False))
        checks.append(check_kernels(
            sweep_model(bt, "gamma", 2, dtype, xreg=True), 256, 10,
            "sweep gamma + xreg", timed=False))
        for m in (1, 3, 4):
            checks.append(check_kernels(
                sweep_model(bt, "poisson", m, dtype), 256, 10,
                f"sweep m={m}", timed=False))
        for N in (2, 32):
            checks.append(check_kernels(
                sweep_model(bt, "poisson", 2, dtype), 256, N,
                f"sweep N={N}", timed=False))
    # a footprint beyond shared memory: K1 stages in device memory
    for m, dtype, n in ((4, torch.float64, 1200), (4, torch.float32, 2200)):
        c = check_kernels(sweep_model(bt, "poisson", m, dtype, n=n), 64, 10,
                          f"long n={n} m={m}", timed=False,
                          k1_only=dtype == torch.float32)
        if c["staging"]["shared"]:
            FAILURES.append({"what": "device-memory staging not reached",
                             "label": c["label"]})
        checks.append(c)
    if not c_4k["staging"]["shared"]:
        FAILURES.append({"what": "shared-memory staging not reached"})
    checks.append({"label": "phase 2 on the card vs on the CPU, f64",
                   "checks": [small_reference(bt)]})
    sweep = staging_sweep(bt)
    for pick in ("shared", "device"):
        if not any(r["picked"] == pick for r in sweep):
            FAILURES.append({"what": f"the wrapper never picked {pick} "
                                     "staging in the staging sweep"})
    # K2 on both sides of its staging limits and both stagings timed, K3 at
    # every segment width
    rts_staging = check_rts_staging(bt)
    rts_sweep = rts_staging_sweep(bt)
    psi_particles = [check_psi_particles(m32, 1024, "main f32 B=1024"),
                     check_psi_particles(m64, 1024, "main f64 B=1024")]
    emit("checks", {"runs": checks, "staging_sweep": sweep,
                    "rts_staging": rts_staging,
                    "rts_staging_sweep": rts_sweep,
                    "psi_particles": psi_particles, "failures": FAILURES})
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} kernel check(s) failed",
              file=sys.stderr)
        return 1

    # ---- K8, one Laplace pass, and the single-model solve ----------------
    s_16k = check_step(m32, 16384, "main f32 B=16384", timed=True)
    s_4k = check_step(m32, 4096, "main f32 B=4096", timed=True)
    s_1 = check_step(m32, 1, "main f32 B=1", timed=True)
    step = [s_16k, s_4k, s_1]
    for B in (16384, 4096, 1):
        step.append(check_step(m64, B, f"main f64 B={B}", timed=False))
    for dtype in (torch.float64, torch.float32):
        for fam in ("svm", "binomial", "negative binomial", "gamma"):
            step.append(check_step(sweep_model(bt, fam, 2, dtype), 256,
                                   f"sweep {fam}", timed=False))
        step.append(check_step(sweep_model(bt, "gamma", 2, dtype, xreg=True),
                               256, "sweep gamma + xreg", timed=False))
        for m in (1, 3, 4):
            step.append(check_step(sweep_model(bt, "poisson", m, dtype), 256,
                                   f"sweep m={m}", timed=False))
    # beyond shared memory (m = 4, n = 1600 float64, 64 rows): tiles with
    # checkpoints; one model's long series in float32, whole in shared
    # memory
    for m, dtype, n, B in ((4, torch.float64, 1600, 64),
                           (2, torch.float32, 2200, 1)):
        c = check_step(sweep_model(bt, "poisson", m, dtype, n=n), B,
                       f"long n={n} m={m}", timed=False)
        if (c["geometry"]["chunk"] == n) != (B == 1):
            FAILURES.append({"what": "laplace_step layout at long n",
                             "label": c["label"],
                             "geometry": c["geometry"]})
        step.append(c)
    single = check_single_solve(m64, 4096, "main f64 B=4096")
    step_layouts_sweep = step_staging_readings(bt)
    emit("step_checks", {"runs": step, "single_solve": single,
                         "layouts": step_layouts_sweep,
                         "failures": FAILURES})
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} laplace_step check(s) failed",
              file=sys.stderr)
        return 1

    # ---- the large-ensemble kernel ----------------------------------------
    big, big_main, t_big = big_section(bt, m32, m64)
    mb32 = calm_model(bt, torch.float32)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} large-ensemble check(s) failed",
              file=sys.stderr)
        return 1

    # ---- the linear-Gaussian kernels ---------------------------------------
    a32 = airquality_model(bt, torch.float32)
    a64 = airquality_model(bt, torch.float64)
    l_16k = check_lg(a32, 16384, "airquality f32 B=16384", timed=True,
                     degenerate_rows=4)
    l_4k = check_lg(a32, 4096, "airquality f32 B=4096", timed=True,
                    degenerate_rows=4)
    # the lg_full path gives the fast smoother chunks of 65536 rows
    l_64k = check_lg(a32, 65536, "airquality f32 B=65536", timed=True)
    lg = [l_16k, l_4k, l_64k,
          check_lg(a64, 16384, "airquality f64 B=16384", timed=False,
                   degenerate_rows=4),
          check_lg(a64, 4096, "airquality f64 B=4096", timed=False,
                   degenerate_rows=4)]
    # the lg_summary and lg_full chains give K6 this batch
    l_1k = check_lg(a32, 1024, "airquality f32 B=1024", timed=True)
    lg.append(l_1k)
    for dtype in (torch.float64, torch.float32):
        for m in (0, 1, 2, 3, 4):
            lg.append(check_lg(lg_sweep_model(bt, m, dtype), 256,
                               f"sweep {'ar1_lg' if m == 0 else f'm={m}'}",
                               timed=False))
    # a per-row D over more than one chunk of K6's tile
    for m, dtype, n in ((2, torch.float32, 600), (2, torch.float64, 300),
                        (4, torch.float64, 300)):
        c = check_lg(lg_sweep_model(bt, m, dtype, n=n), 256,
                     f"chunked D n={n} m={m}", timed=False,
                     degenerate_rows=3)
        if c.get("D_tile", {}).get("chunk", n) >= n:
            FAILURES.append({"what": "D tile not chunked", "label":
                             c["label"]})
        lg.append(c)
    # the smoother over long series (its tiles many times over)
    for m, dtype, n in ((2, torch.float32, 1200), (4, torch.float64, 1200)):
        lg.append(check_lg(lg_sweep_model(bt, m, dtype, n=n), 256,
                           f"long n={n} m={m}", timed=False))
    layouts = [check_layouts(m32, a32, 4096, "layouts f32 B=4096",
                             timed=True),
               check_layouts(m64, a64, 1024, "layouts f64 B=1024",
                             timed=False)]
    fs_sweep = fs_staging_sweep(bt)
    for pick in ("shared", "checkpoint"):
        if not any(r["picked"] == pick for r in fs_sweep):
            FAILURES.append({"what": f"the smoother's rule never picked "
                                     f"{pick} staging in its sweep"})
    emit("lg_checks", {"runs": lg, "layouts": layouts,
                       "fs_staging_sweep": fs_sweep, "failures": FAILURES})
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} linear-Gaussian check(s) failed",
              file=sys.stderr)
        return 1

    # ---- the SV family at n = 945, per-row systems ------------------------
    sv = sv_checks(bt)
    emit("sv_checks", {**sv, "failures": FAILURES})
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} SV / per-row check(s) failed",
              file=sys.stderr)
        return 1

    # ---- the paths, each at full width ------------------------------------
    it_full = args.iter
    it_half = max(args.iter // 2, 40)
    lvl_slope = "bsm_ng poisson level+slope, n=153, m=2, d=2, float32"
    runs = [
        run_path(bt, ck, m32, "psi_N10", lvl_slope, CHAINS, it_full,
                 ("laplace_solve", "rts_factors", "psi_logw"), (0.15, 0.35),
                 0.95, particles=10, **is2),
        run_path(bt, ck, m32, "psi_N256", lvl_slope, CHAINS, it_full,
                 ("laplace_solve", "rts_factors", "psi_big_logw"),
                 (0.15, 0.35), 0.99, particles=256, psi_resample_every=8,
                 **is2),
        run_path(bt, ck, m32, "psi_N256_refexact", lvl_slope, CHAINS // 4,
                 it_full, ("laplace_solve", "rts_factors", "psi_big_logw"),
                 (0.15, 0.35), 0.99, particles=256, psi_resample_every=1,
                 **is2),
        run_path(bt, ck, mb32, "pm_bsf_N200",
                 "bsm_ng poisson level only, n=153, m=1, d=1, float32",
                 CHAINS // 4, it_half, ("bsf_big_logw",), (0.10, 0.45), None,
                 particles=200, mcmc_type="pm", sampling_method="bsf"),
        run_path(bt, ck, m32, "da_psi_N64", lvl_slope, CHAINS // 4, it_half,
                 ("laplace_solve", "rts_factors", "psi_big_logw"),
                 (0.05, 0.35), None, particles=64, mcmc_type="da",
                 sampling_method="psi"),
        run_path(bt, ck, gamma_airquality_model(bt, torch.float32),
                 "gamma_airquality_N10", "bsm_ng gamma airquality Ozone ~ "
                 "Wind + Temp, level+slope, n=153, m=2, d=5, float32",
                 CHAINS, it_full, ("laplace_solve", "rts_factors",
                                   "psi_logw"), (0.15, 0.35), None,
                 particles=10, **is2)]
    aq = "bsm_lg airquality Ozone ~ Wind + Temp, level+slope, n=153, m=2, " \
        "d=5, float32"
    runs += [run_path(bt, ck, a32, "lg_" + ot, aq,
                      CHAINS if ot == "theta" else CHAINS // 4, it_full,
                      req, (0.15, 0.6), None, output_type=ot)
             for ot, req in (("theta", ("log_likelihood",)),
                             ("summary", ("log_likelihood",)),
                             ("full", ("log_likelihood", "fast_smoother_ll")))]
    # the state outputs of the non-Gaussian model: one seed, so one theta
    # chain for all three runs
    st_kw = dict(particles=10, sampling_method="psi", store_modes=True,
                 corr_batch=16384)
    req = ("laplace_solve", "rts_factors")
    runs += [
        run_path(bt, ck, m32, "is2_full", lvl_slope, CHAINS // 4, it_full,
                 req, (0.15, 0.35), 0.95, mcmc_type="is2",
                 output_type="full", **st_kw),
        run_path(bt, ck, m32, "is1_summary", lvl_slope, CHAINS // 4, it_full,
                 req, (0.15, 0.35), None, mcmc_type="is1",
                 output_type="summary", **st_kw),
        run_path(bt, ck, m32, "approx_full", lvl_slope, CHAINS // 4, it_full,
                 ("laplace_solve", "fast_smoother_ll"), (0.15, 0.35), None,
                 mcmc_type="approx", output_type="full", store_modes=True)]
    # models outside the kernels' contract (period-12 seasonal, m = 12 and
    # 13): the plain versions on the card, every plain route counted; the
    # is2 chain runs 300 iterations: at 200 its acceptance read 0.348 on an
    # H100, inside the band's upper edge by 0.002 (PERF.md)
    s_ng, s_lg = seasonal_models(bt, torch.float32)
    runs += [
        run_path(bt, ck, s_ng, "seasonal_ng_is2",
                 "bsm_ng poisson level+seasonal(12), n=144, m=12, d=2, "
                 "float32", CHAINS // 16, max(args.iter * 3 // 10, 40), (),
                 (0.15, 0.35), 0.9,
                 plain=("laplace_solve", "rts_factors", "psi_logw"),
                 particles=10, **is2),
        run_path(bt, ck, s_lg, "seasonal_lg_gaussian",
                 "bsm_lg level+slope+seasonal(12), n=144, m=13, d=4, "
                 "float32", CHAINS // 4, it_half, (), (0.15, 0.6), None,
                 plain=("log_likelihood",), output_type="summary",
                 corr_batch=8192)]
    paths = [r for r, _ in runs]
    outs = {r["path"]: o for r, o in runs}
    problems = [p for r in paths for p in r["problems"]]
    ga = ess_fraction_check(outs["gamma_airquality_N10"], GAMMA_ESS_REF)
    next(r for r in paths
         if r["path"] == "gamma_airquality_N10")["ess_vs_reference"] = ga
    if not ga["ok"]:
        problems.append(f"gamma_airquality_N10: ESS_IS fraction against "
                        f"the reference's {ga}")
    # post_correct replays is2_full's correction on the approx run
    r_ap = next(r for r in paths if r["path"] == "approx_full")
    pc, pc_s, pc_launches, pc_plain = keyword_post_correct(
        bt, ck, m32, outs["approx_full"])
    wdiff = float(np.abs(pc.weights.astype(np.float64)
                         - outs["is2_full"].weights).max())
    r_ap["post_correct"] = {
        "elapsed_s": pc_s, "launches": pc_launches,
        "max_abs_weight_diff_vs_is2_full": wdiff,
        "alpha_equal_to_is2_full": bool(np.array_equal(
            pc.alpha, outs["is2_full"].alpha))}
    r_ap["launches"] = {k: r_ap["launches"][k] + pc_launches[k]
                        for k in ck.LAUNCHES}
    r_ap["post_correct"]["plain_routes"] = pc_plain
    if any(pc_plain.values()):
        problems.append(f"approx_full: post_correct took plain routes "
                        f"{pc_plain}")
    if not wdiff <= 1e-6:
        problems.append(f"approx_full: post_correct weights differ from "
                        f"is2_full's by {wdiff}")
    # the JAX package's call forms, the positional post_correct against pc
    api = api_phase(bt, ck, m32, a32, outs, pc, pc_launches)
    problems += api["problems"]
    paths.append({"path": "api", "launches": api["launches"],
                  "problems": [], "emitted": True})
    del pc
    st = is_states_check(outs["is1_summary"], outs["is2_full"])
    next(r for r in paths if r["path"] == "is1_summary")["states_check"] = st
    if not st["ok"]:
        problems.append(f"is1_summary: disagrees with is2_full's draws {st}")
    proper = bt.bsm_ng(main_path_series(),
                       sd_level=bt.halfnormal_prior(0.1, 1.0),
                       sd_slope=bt.halfnormal_prior(0.01, 0.1),
                       distribution="poisson", a1=np.array([1.0, 0.0]),
                       P1=np.diag([1.0, 0.01]), dtype=torch.float32,
                       device="cuda")
    ng = ng_api_path(bt, ck, m32, proper)
    paths.append(ng)
    problems += ng["problems"]
    # the other univariate models: svm (exchange-rate length), ar1_ng
    # pseudo-marginal, and the main path's model and airquality's local
    # linear trend through user update functions
    new_runs = [
        run_path(bt, ck, svm_model(bt, torch.float32), "svm_is2_N64",
                 "svm sigma type, simulated n=945, m=1, d=3, float32",
                 CHAINS // 2, it_full,
                 ("laplace_solve", "rts_factors", "psi_big_logw"),
                 (0.10, 0.65), 0.9, particles=64, psi_resample_every=4,
                 **{**is2, "corr_batch": 8192}),
        run_path(bt, ck, ar1_negbin_model(bt, torch.float32),
                 "ar1_ng_negbin_pm_N10", "ar1_ng negative binomial, n=153, "
                 "m=1, d=4, float32", CHAINS // 4, it_half,
                 ("laplace_solve", "rts_factors", "psi_logw"), (0.10, 0.55),
                 None, particles=10, mcmc_type="pm", sampling_method="psi"),
        run_path(bt, ck, ssm_ung_model(bt, torch.float32), "ssm_ung_is2",
                 "ssm_ung poisson level+slope (the main path's model, R "
                 "from update_fn), n=153, m=2, d=2, float32", CHAINS,
                 it_full, ("laplace_solve", "rts_factors", "psi_logw"),
                 (0.15, 0.35), 0.95, particles=10, **is2),
        run_path(bt, ck, ssm_ulg_model(bt, torch.float32),
                 "ssm_ulg_gaussian", "ssm_ulg airquality Ozone local linear "
                 "trend (H, R from update_fn), n=153, m=2, d=3, float32",
                 CHAINS, it_full, ("log_likelihood",), (0.15, 0.6), None)]
    paths += [r for r, _ in new_runs]
    outs.update({r["path"]: o for r, o in new_runs})
    problems += [p for r, _ in new_runs for p in r["problems"]]
    diag = diagnostics_phase(bt, m32, outs["psi_N10"],
                             dict(output_type="theta", n_chains=CHAINS,
                                  particles=10, **is2))
    problems += diag["problems"]
    # the non-Gaussian MCMC options, predict / fitted and their phases
    opt_paths, opt_outs, phases, opt_problems = options_section(
        bt, ck, m32, mb32, outs, it_full, it_half, lvl_slope, is2)
    paths += opt_paths
    outs.update(opt_outs)
    problems += opt_problems
    # the multivariate models (no kernel; every count must stay 0)
    t_mv = time.time()
    mv_paths, mv_problems = mv_section(bt, ck, it_full, args.mv_iter)
    mv_paths[0]["mv_section_s"] = time.time() - t_mv
    paths += mv_paths
    # the nonlinear models (no kernel on their paths either)
    nlg_paths, nlg_problems, nlg_phase = nlg_section(
        bt, ck, min(it_full, NLG_EKF_ITER), min(it_full, NLG_ITER))
    paths += nlg_paths
    # the SDE models (no kernel on their paths) and as_bssm (whose runs
    # launch K6 and K1-K3)
    sde_paths, sde_problems, sde_phase = sde_section(
        bt, ck, min(it_full, SDE_GBM_ITER), min(it_full, SDE_OU_ITER))
    paths += sde_paths
    # the time-parallel option: no Laplace kernel, the correction's K2-K4
    tp_paths, tp_problems, tp_phase = tp_section(
        bt, ck, min(it_full, TP_ITER), min(it_full, TP_SV_ITER), is2)
    paths += tp_paths
    # the mesh: a world of one over NCCL here, two gloo ranks in processes
    # of their own (their launches are in the mesh line)
    mesh_paths, mesh_problems, mesh_phase = mesh_section(bt, ck)
    paths += mesh_paths
    problems += mv_problems + nlg_problems + sde_problems + tp_problems \
        + mesh_problems + [f["what"] for f in FAILURES]
    # the replication grid's launches count as one more path's
    paths.append({"path": "replications", "launches":
                  phases["replications"].get(
                      "launches", {k: 0 for k in ck.LAUNCHES}),
                  "replayed": phases["replications"].get("replayed", {}),
                  "problems": [], "emitted": True})
    for r in paths:
        if r["path"].startswith("lg_"):
            r["parity_r05_posterior_mean"] = LG_PARITY
            r["posterior_mean"] = dict(zip(
                outs[r["path"]].theta_names,
                outs[r["path"]].flat_theta().mean(0).tolist()))
    states = lg_states_check(outs["lg_summary"], outs["lg_full"])
    next(r for r in paths if r["path"] == "lg_full")["states_check"] = states
    if not states["ok"]:
        problems.append(f"lg_full: draws disagree with lg_summary {states}")
    total = {k: sum(r["launches"][k] for r in paths) for k in ck.LAUNCHES}
    by_path = {k: {r["path"]: r["launches"][k] for r in paths}
               for k in ck.LAUNCHES}

    b = c_16k["bounds"]
    b4 = c_4k["bounds"]
    src = {"laplace_solve": ("laplace_solve.cu", 920),
           "rts_factors": ("rts_factors.cu", 1495),
           "psi_logw": ("psi_logw.cu", 1843)}
    worst = {k: max(c["max_abs_err"] for c in c_16k["checks"]
                    if c["what"].startswith(k)) for k in src}
    kernels = []
    for name, (f, line) in src.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"bssm_tpu_torch/csrc/{f}",
            "replaces": f"bssm_tpu/ops/pallas_kalman.py:{line}",
            "launches": total[name], "launches_by_path": by_path[name],
            "max_abs_err": worst[name],
            "ms": c_16k["ms"][name], "plain_ms": c_16k["plain_ms"][name],
            "bound_ms": b[name]["bound_ms"], "bound_by": b[name]["bound_by"],
            "library_ms": None, "shape": "B=16384 n=153 m=2 N=10 float32"})
    # bare kernels, and the readings at the 1024 chains of seven paths and
    # at B = 4096 (phase 1 gives laplace_solve B = 4096 rows)
    for k in kernels:
        name = k["name"]
        k["bare_ms"] = c_16k["bare_ms"][name]
        k["ms_B1024"] = c_1k["ms"][name]
        k["bare_ms_B1024"] = c_1k["bare_ms"][name]
        k["plain_ms_B1024"] = c_1k["plain_ms"][name]
        k["bound_ms_B1024"] = c_1k["bounds"][name]["bound_ms"]
        k["ms_B4096"] = c_4k["ms"][name]
        k["bare_ms_B4096"] = c_4k["bare_ms"][name]
        k["plain_ms_B4096"] = c_4k["plain_ms"][name]
        k["bound_ms_B4096"] = b4[name]["bound_ms"]
    # and at svm_is2_N64's correction chunks: the SV family, n = 945, m = 1
    sv_k = sv["runs"][0]
    for k in kernels:
        name = k["name"]
        k["shape_sv"] = "svm B=8192 n=945 m=1 N=10 float32"
        k["ms_sv"] = sv_k["ms"][name]
        k["bare_ms_sv"] = sv_k["bare_ms"][name]
        k["plain_ms_sv"] = sv_k["plain_ms"][name]
        k["bound_ms_sv"] = sv_k["bounds"][name]["bound_ms"]
        k["bound_by_sv"] = sv_k["bounds"][name]["bound_by"]
    kernels[0]["laplace_niter_mean_sv"] = sv_k["laplace_niter_mean"]
    k7_new = {(r["shape"], r["dtype"]): r
              for r in phases["global_checks"].get("runs", [])}
    for name, line in (("log_likelihood", 386), ("fast_smoother_ll", 487)):
        lb = l_16k["bounds"][name]
        k = {"name": name, "route": "cuda",
             "source": "bssm_tpu_torch/csrc/kalman_filter.cu",
             "replaces": f"bssm_tpu/ops/pallas_kalman.py:{line}",
             "launches": total[name], "launches_by_path": by_path[name],
             "max_abs_err": max(c["max_abs_err"] for run in lg[:3]
                                for c in run["checks"]
                                if c["what"].startswith(name)),
             "ms": l_16k["ms"][name], "plain_ms": l_16k["plain_ms"][name],
             "bound_ms": lb["bound_ms"], "bound_by": lb["bound_by"],
             "library_ms": None, "shape": "B=16384 n=153 m=2 float32",
             "bare_ms": l_16k["bare_ms"][name]}
        if name == "fast_smoother_ll":
            k["geometry_B65536"] = l_64k["fs_geometry"]
            for tag, key in (("_global_B4096", ("global", "float32")),
                             ("_spdk_B81920", ("spdk", "float32"))):
                run = k7_new.get(key, {})
                for f in ("ms", "bare_ms", "plain_ms"):
                    k[f + tag] = run.get(f)
                k["bound_ms" + tag] = run.get("bounds", {}).get("bound_ms")
                k["max_abs_err" + tag] = max(
                    [c["max_abs_err"] for c in run.get("checks", [])]
                    or [None])
        for tag, run in (("_B4096", l_4k), ("_B1024", l_1k),
                         ("_B65536", l_64k)):
            k["ms" + tag] = run["ms"][name]
            k["bare_ms" + tag] = run["bare_ms"][name]
            k["plain_ms" + tag] = run["plain_ms"][name]
            k["bound_ms" + tag] = run["bounds"][name]["bound_ms"]
        kernels.append(k)
    k8 = {"name": "laplace_step", "route": "cuda",
          "source": "bssm_tpu_torch/csrc/laplace_solve.cu",
          "replaces": "bssm_tpu/ops/pallas_kalman.py:680",
          "launches": total["laplace_step"],
          "launches_by_path": by_path["laplace_step"],
          "max_abs_err": max(c["max_abs_err"] for run in (s_16k, s_4k, s_1)
                             for c in run["checks"]),
          "library_ms": None, "shape": "B=16384 n=153 m=2 float32",
          "geometry_B1": s_1["geometry"]}
    for tag, run in (("", s_16k), ("_B4096", s_4k), ("_B1", s_1)):
        k8["ms" + tag] = run["ms"]
        k8["bare_ms" + tag] = run["bare_ms"]
        k8["plain_ms" + tag] = run["plain_ms"]
        k8["bound_ms" + tag] = run["bounds"]["bound_ms"]
        k8["bound_by" + tag] = run["bounds"]["bound_by"]
    kernels.append(k8)
    for name, line in (("psi_big_logw", 2303), ("bsf_big_logw", 2484)):
        t = t_big[name]
        err = max([c["max_abs_err"] for run in big_main
                   if run["dtype"] == "float32" for c in run["checks"]
                   if c["what"] == name] + [t["check"]["max_abs_err"]])
        k = {"name": name, "route": "cuda",
             "source": "bssm_tpu_torch/csrc/particle_big.cu",
             "replaces": f"bssm_tpu/ops/pallas_kalman.py:{line}",
             "launches": total[name], "launches_by_path": by_path[name],
             "max_abs_err": err, "library_ms": None}
        k.update({key: v for key, v in t.items() if key != "check"})
        if name == "psi_big_logw":
            t = sv["psi_big_times"]
            k.update({"shape_sv": t["shape"], "ms_sv": t["ms"],
                      "bare_ms_sv": t["bare_ms"],
                      "plain_ms_sv": t["plain_ms"],
                      "bound_ms_sv": t["bound_ms"],
                      "bound_by_sv": t["bound_by"]})
        kernels.append(k)
    for k in kernels:
        if k["launches"] <= 0:
            problems.append(f"kernel {k['name']} was launched by no path")
        # kernels run again by CUDA-graph replays (pm / da with states),
        # apart from the wrappers' launches
        k["replayed"] = sum(r.get("replayed", {}).get(k["name"], 0)
                            for r in paths)
        k["replayed_by_path"] = {
            r["path"]: r["replayed"][k["name"]] for r in paths
            if r.get("replayed", {}).get(k["name"])}

    for r in paths:
        if r.get("emitted"):
            continue
        r["total_s"] = time.time() - t_start
        emit("main_path" if r["path"] == "psi_N10" else "path", r)
    emit("diagnostics", diag)
    emit("nlg_checks", nlg_phase)
    emit("sde_checks", sde_phase)
    emit("tp_checks", tp_phase)
    emit("mesh", mesh_phase)
    emit("api", api)
    print(json.dumps({"kernels": kernels}), flush=True)
    if problems:
        print("chip_smoke: paths failed: " + "; ".join(problems),
              file=sys.stderr)
        return 1
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
