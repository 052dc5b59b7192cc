#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package ``bssm_tpu_torch`` on one NVIDIA GPU.

    python3 chip_smoke.py            # full run, needs one CUDA device
    python3 chip_smoke.py --iter 200 # shorter main path

What it does, in order:

1. builds the CUDA kernels from ``bssm_tpu_torch/csrc`` (nvcc, sm_90a);
2. holds each kernel (``laplace_solve``, ``rts_factors``, ``psi_logw``)
   against its plain PyTorch version on the card, at the main path's shapes
   (n = 153, m = 2, Poisson, B = 4096 / 16384 rows, N = 10 particles) in
   float32 and float64, and at small shapes over the other state dimensions,
   observation families and particle counts; times kernel and plain version
   with CUDA events;
3. drives the main path through the public entry points: IS-MCMC
   (``mcmc_type="is2"``, psi-APF correction) on a level + slope ``bsm_ng``
   Poisson model, 4096 chains, and checks finite posteriors, the acceptance
   rate, the importance-sampling effective sample size and that every kernel
   was launched by that run;
4. prints one JSON object per line: ``card``, ``checks``, ``kernels``,
   ``main_path``, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Any failed check ends the run with a non-zero exit code and without the last
line.  Tolerances (|a - b| <= tol (1 + |b|)):
  float64: 1e-9 on every output of every kernel;
  float32: laplace_solve mode 1e-4, log-likelihood 1e-3; rts_factors ahat
  1e-4 (1e-3 for m >= 3), Ab 1e-3, Lb Lb' 5e-3; psi_logw 1e-4.  In float32 a
  kernel and its plain version sum in different orders, and a difference of
  one ulp can flip a discrete decision (an eigenvalue clip, a resampled
  ancestor, the pass at which an iteration stops), after which that row
  differs visibly.  So in float32 the tolerance must hold for 99% of the
  entries, every entry must stay inside 100x the tolerance or 0.5, whichever
  is larger, and the share of entries outside the tolerance is printed.
"""
from __future__ import annotations

import argparse
import json
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

def main_path_series() -> np.ndarray:
    """The benchmark series of the JAX package's bench.py: n = 153 Poisson
    counts around a slowly drifting level (numpy recipe, seed 1)."""
    rng = np.random.default_rng(1)
    n = 153
    slope = np.cumsum(rng.normal(0, 0.01, n))
    level = np.cumsum(slope + rng.normal(0, 0.1, n)) + 2.0
    y = rng.poisson(np.exp(0.5 * level / np.abs(level).max() + 1.0))
    return y.astype(float)


def main_path_model(bt, dtype):
    return bt.bsm_ng(main_path_series(),
                     sd_level=bt.halfnormal_prior(0.1, 1.0),
                     sd_slope=bt.halfnormal_prior(0.01, 0.1),
                     distribution="poisson", dtype=dtype, device="cuda")


def sweep_model(bt, family: str, m: int, dtype, n: int = 40,
                xreg: bool = False):
    """A small bsm_ng model with state dimension ``m`` (1: level, 2: level +
    slope, 3: level + seasonal(3), 4: level + slope + seasonal(3)) and two
    missing observations; ``xreg`` adds two regressors, which make the
    intercept D vary over time and over rows."""
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
    if xreg:
        kw["xreg"] = rng.normal(0, 0.3, (n, 2))
        kw["beta"] = bt.normal_prior(np.zeros(2), 0.0, 1.0)
    return bt.bsm_ng(y, **kw)


def thetas_around_init(model, B: int, seed: int, spread: float = 0.5):
    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = torch.as_tensor(model.theta_init, dtype=model.dtype, device="cuda")
    return t0 + spread * torch.randn((B, t0.shape[0]), dtype=model.dtype,
                                     device="cuda", generator=g)


# ---------------------------------------------------------------------------
# kernel against plain version
# ---------------------------------------------------------------------------

def check_kernels(model, B: int, N: int, label: str, timed: bool,
                  seed: int = 7) -> dict:
    """Runs the three kernels and their plain versions on the same inputs on
    the card; returns errors and (when ``timed``) milliseconds."""
    from bssm_tpu_torch.inference import approx as amod
    from bssm_tpu_torch.inference import particle as pmod
    from bssm_tpu_torch.ops import cuda_kalman as ck
    from bssm_tpu_torch.ops import kalman

    dt = model.dtype
    f64 = dt == torch.float64
    strict = f64
    m = model.extra["m"]
    tol = (lambda k: F64_TOL) if f64 else (lambda k: F32_TOL[k])
    spec = model.build(thetas_around_init(model, B, seed))
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
    return out


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
    # one masked Joseph-form Kalman step with prediction
    kf = 2 * mm + 4 * m + 3 * m + 2 * (2 * m ** 3 + mm) + 3 * mm \
        + 2 * (2 * m ** 3) + 2 * mm + 2 * mm + 12
    match = 12                               # exp, divide and a few products
    bwd_mean = 2 * mm + 2 * mm + 6 * mm + 2 * mm + 4 * m
    k1_ops = total_passes * n * (kf + match + bwd_mean + 2 * m + 3)
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
    res = {}
    for name, ops, byts in (("laplace_solve", k1_ops, k1_bytes),
                            ("rts_factors", k2_ops, k2_bytes),
                            ("psi_logw", k3_ops, k3_bytes)):
        t_b = byts / PEAK_BYTES_PER_S * 1e3
        t_o = ops / PEAK_F32_FLOPS * 1e3
        res[name] = {"bytes": byts, "operations": ops,
                     "bound_ms": max(t_b, t_o),
                     "bound_by": "bytes" if t_b >= t_o else "operations"}
    return res


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


def profile_main_path(bt, model, run: dict, iters: int = 60) -> dict:
    """Device time by kernel over a short main-path run, and the share of
    the wall time the device was busy.  The same run is timed first without
    the profiler, whose own cost inflates the host side."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.time()
    bt.run_mcmc(model, iter=iters, **run)
    torch.cuda.synchronize()
    wall_plain = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = bt.run_mcmc(model, iter=iters, **run)
        torch.cuda.synchronize()
        wall_prof = time.time() - t0

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return float(getattr(e, attr))
        return 0.0

    rows = [(e.key, int(e.count), dev_us(e)) for e in prof.key_averages()]
    rows = [r for r in rows if r[2] > 0]
    rows.sort(key=lambda r: -r[2])
    total_us = sum(r[2] for r in rows)
    return {"iter": iters, "chains": run["n_chains"],
            "wall_s_unprofiled": wall_plain, "wall_s_profiled": wall_prof,
            "phase_s_profiled": out.time,
            "device_busy_s": total_us * 1e-6,
            "device_busy_share_of_unprofiled_wall":
                total_us * 1e-6 / wall_plain,
            "device_kernel_launches": sum(r[1] for r in rows),
            "top_by_device_time": [
                {"name": k[:80], "count": c, "device_ms": us * 1e-3,
                 "share": us / max(total_us, 1e-9)} for k, c, us in rows[:14]]}


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iter", type=int, default=1000,
                    help="iterations of the main path (default 1000)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace a short main-path run with "
                         "torch.profiler and print device time by kernel")
    args = ap.parse_args()

    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import bssm_tpu_torch as bt
    from bssm_tpu_torch.ops import cuda_kalman as ck
    assert "jax" not in sys.modules and "bssm_tpu" not in sys.modules

    smi = nvidia_smi_line()
    ck.build()
    nvcc = subprocess.run([ck._find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    emit("card", {"nvidia_smi": smi, "torch": torch.__version__,
                  "cuda": torch.version.cuda,
                  "nvcc": nvcc.stdout.strip().splitlines()[-1],
                  "build_seconds": ck.build_seconds,
                  "tf32_matmul": torch.backends.cuda.matmul.allow_tf32})

    # ---- kernels against their plain versions -----------------------------
    checks = []
    m32 = main_path_model(bt, torch.float32)
    m64 = main_path_model(bt, torch.float64)
    c_16k = check_kernels(m32, 16384, 10, "main f32 B=16384", timed=True)
    c_4k = check_kernels(m32, 4096, 10, "main f32 B=4096", timed=True)
    checks += [c_16k, c_4k,
               check_kernels(m64, 16384, 10, "main f64 B=16384", timed=True),
               check_kernels(m64, 4096, 10, "main f64 B=4096", timed=False)]
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
    checks.append({"label": "phase 2 on the card vs on the CPU, f64",
                   "checks": [small_reference(bt)]})
    emit("checks", {"runs": checks, "failures": FAILURES})
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} kernel check(s) failed",
              file=sys.stderr)
        return 1

    # ---- main path --------------------------------------------------------
    run = dict(particles=10, mcmc_type="is2", sampling_method="psi",
               output_type="theta", store_modes=False, n_chains=CHAINS,
               corr_batch=16384, seed=1)
    bt.run_mcmc(m32, iter=20, **run)                      # warm-up
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.time()
    out = bt.run_mcmc(m32, iter=args.iter, **run)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = dict(ck.LAUNCHES)

    w = out.flat_weights()
    ess_frac = bt.ess_is(w) / w.size
    finite = bool(np.isfinite(out.posterior).all()
                  and np.isfinite(out.theta).all()
                  and np.isfinite(out.weights).all())
    sd = out.flat_theta()
    post_mean = [float(bt.weighted_mean(sd[:, j], w)) for j in range(2)]
    main_path = {
        "model": "bsm_ng poisson level+slope, n=153, m=2, d=2, float32",
        "chains": CHAINS, "iter": args.iter, "particles": 10,
        "corr_batch": 16384, "elapsed_s": elapsed, "time": out.time,
        "samples_per_s": CHAINS * args.iter / elapsed,
        "acceptance_rate": out.acceptance_rate, "ess_is_fraction": ess_frac,
        "heads_corrected": out.n_corrected, "finite": finite,
        "posterior_mean_sd": post_mean, "launches": launches,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    problems = []
    if not finite:
        problems.append("non-finite posterior values")
    if not 0.15 <= out.acceptance_rate <= 0.35:
        problems.append(f"acceptance rate {out.acceptance_rate}")
    if not ess_frac >= 0.95:
        problems.append(f"ESS_IS fraction {ess_frac}")
    for k, v in launches.items():
        if v <= 0:
            problems.append(f"kernel {k} was not launched by the main path")
    if out.theta.shape != (CHAINS, args.iter - args.iter // 2, 2):
        problems.append(f"theta shape {out.theta.shape}")
    main_path["problems"] = problems

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
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": c_16k["ms"][name], "plain_ms": c_16k["plain_ms"][name],
            "bound_ms": b[name]["bound_ms"], "bound_by": b[name]["bound_by"],
            "library_ms": None, "shape": "B=16384 n=153 m=2 N=10 float32"})
    # phase 1 gives laplace_solve B = 4096 rows: that reading too
    kernels[0]["ms_B4096"] = c_4k["ms"]["laplace_solve"]
    kernels[0]["plain_ms_B4096"] = c_4k["plain_ms"]["laplace_solve"]
    kernels[0]["bound_ms_B4096"] = b4["laplace_solve"]["bound_ms"]
    main_path["total_s"] = time.time() - t_start
    emit("main_path", main_path)
    if args.profile:
        emit("profile", profile_main_path(bt, m32, run))
    print(json.dumps({"kernels": kernels}), flush=True)
    if problems:
        print("chip_smoke: main path failed: " + "; ".join(problems),
              file=sys.stderr)
        return 1
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
