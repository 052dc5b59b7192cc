"""Hand-written CUDA kernels of the state-space hot paths, their build and
their wrappers.  Counterpart of ``bssm_tpu/ops/pallas_kalman.py``.

Five sources in ``bssm_tpu_torch/csrc/`` (CUDA C++ for sm_90a), nine
wrappers:

================  ======================  ===================================
wrapper           source                  plain version
================  ======================  ===================================
log_likelihood    csrc/kalman_filter.cu   ops/kalman.log_likelihood
fast_smoother_ll  csrc/kalman_filter.cu   ops/kalman.fast_smoother_ll
laplace_solve     csrc/laplace_solve.cu   inference/approx.laplace_solve_plain
laplace_step      csrc/laplace_solve.cu   inference/approx._laplace_step
rts_factors       csrc/rts_factors.cu     ops/kalman.smoother_bwd_factors
psi_logw          csrc/psi_logw.cu        inference/particle.psi_logw_scan
psi_big_logw      csrc/particle_big.cu    inference/particle.psi_logw_scan
                                          (with ``resample_every``)
bsf_big_logw      csrc/particle_big.cu    inference/particle.bsf_logw_scan
philox_fill       csrc/particle_big.cu    philox_fill_plain (this module)
================  ======================  ===================================

``log_likelihood`` and ``fast_smoother_ll`` serve linear-Gaussian models:
the Kalman log-likelihood (the target of linear-Gaussian MCMC) and the
smoothed means with it (the conditional means of the simulation smoother).

``laplace_solve`` runs the whole Laplace iteration of a batch of models
(the chains, the stored draws); ``laplace_step`` one pass of it, which the
single-model solve (``inference/approx.laplace_solve_steps``) loops over.

``psi_logw`` serves N <= 32 particles from injected randomness.
``psi_big_logw`` and ``bsf_big_logw`` are the two modes of one kernel for
2 <= N <= 512 particles with a resampling period; they take their
randomness either injected (``eps``, ``us``: stream mode) or from a Philox
key that the kernel expands itself (``seed``), which is what the MCMC paths
use.  ``philox_fill`` writes the tensors the Philox mode would consume, so
that the two modes can be compared.

Each wrapper checks its inputs, allocates outputs and scratch with
``torch.empty``, launches on PyTorch's current stream, checks the launch
error and raises, does not synchronise, and adds one to its entry of
``LAUNCHES``.  Given tensors on the CPU it calls the plain version; given
CUDA tensors it launches the kernel or raises.  Nothing falls back.

Build: at the first CUDA call, ``nvcc`` compiles every ``csrc/*.cu`` (one
process per source, started together) for ``sm_90a`` and links them into
``bssm_tpu_torch/_build/libbssm_kernels.so``, which is loaded with
``ctypes``.  The library is rebuilt when the hash of the sources changes.
Importing this module needs neither ``nvcc`` nor a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from ..core.spec import LGSpec, NGSpec, SVM, GAMMA, with_batch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libbssm_kernels.so"

MAX_M = 4
MAX_N_PSI = 32
MAX_N_BIG = 512
# Threads per block.  The row-per-thread kernels use blocks of one warp so
# that a few thousand rows still spread over every SM; psi_logw gives each
# row a warp, four rows to a block.
THREADS_PER_ROW_BLOCK = 32
THREADS_PSI_BLOCK = 128

# launches of each kernel since the last reset_launch_counts()
LAUNCHES = {"log_likelihood": 0, "fast_smoother_ll": 0, "laplace_solve": 0,
            "laplace_step": 0, "rts_factors": 0, "psi_logw": 0, "psi_big_logw": 0,
            "bsf_big_logw": 0, "philox_fill": 0}

# seconds the last build took (None: library was already built or not loaded)
build_seconds: Optional[float] = None

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256()
    cus, hdrs = _sources()
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built.")


def build() -> Path:
    """Compile csrc/*.cu into the shared library if it is missing or stale;
    returns its path.  Raises with nvcc's output when the build fails; the
    output, with each kernel's registers and spills (``-Xptxas -v``), is kept
    in ``_build/build.log``."""
    global build_seconds
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    digest = _source_hash()
    if lib.is_file() and stamp.is_file() \
            and stamp.read_text().strip() == digest:
        return lib
    t0 = time.time()
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    tag = f"{os.getpid()}"
    procs = []
    for src in cus:        # one nvcc per source, all started together
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *flags, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (exit {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    objs = [str(o) for _, o, _ in procs]
    try:
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                               + "\n".join(log))
        tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed\n" + "\n".join(log))
        os.replace(tmp, lib)
        stamp.write_text(digest + "\n")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
    build_seconds = time.time() - t0
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    P, L, I, Dbl = (ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                    ctypes.c_double)
    for fn in (lib.bssm_kalman_ll, lib.bssm_fast_smoother_ll):
        fn.restype = I
    series = [P, L, L] * 3        # y, h2, D, each with batch and time stride
    lib.bssm_kalman_ll.argtypes = [
        I, I, L, I, *series,      # is_double, m, B, n
        P, P, I, P]               # sys, ll, threads, stream
    lib.bssm_fast_smoother_ll.argtypes = [
        I, I, L, I, *series,
        P, P, P, P, I, P]         # sys, alpha, ll, scratch, threads, stream
    lib.bssm_laplace_solve.restype = I
    lib.bssm_laplace_solve.argtypes = [
        I, I, I, L, I,            # is_double, m, dist, B, n
        P, L, P, L, P, L, L,      # y, u, D (+strides)
        P, L, P,                  # mode0 (+stride), sys
        Dbl, I,                   # conv_tol, max_iter
        P, P, P, P, P, P,         # mode, prev, ll, niter, diff, scratch
        I, P]                     # threads, stream
    lib.bssm_laplace_step.restype = I
    lib.bssm_laplace_step.argtypes = [
        I, I, I, L, I,            # is_double, m, dist, B, n
        P, L, P, L, P, L, L,      # y, u, D (+strides)
        P, L, P,                  # mode (+stride), sys
        P, P, P, P,               # new mode, ll, diff, scratch
        I, P]                     # threads, stream
    lib.bssm_rts_factors.restype = I
    lib.bssm_rts_factors.argtypes = [
        I, I, L, I,               # is_double, m, B, n
        P, L, P, L, L, P, L, L,   # y, H, D (+strides)
        P, P, P, P, P,            # sys, ahat, Lb, Ab, scratch
        I, P]
    lib.bssm_psi_logw.restype = I
    lib.bssm_psi_logw.argtypes = [
        I, I, I, I, L, I,         # is_double, m, dist, N, B, n
        P, P, P, L, P, L, P,      # ytilde, Htilde, y, u, scales
        P, L, L, P,               # D (+strides), zphi
        P, P, P, P, P, P,         # ahat, Lb, Ab, eps, us, logw
        I, P]
    lib.bssm_particle_big.restype = I
    lib.bssm_particle_big.argtypes = [
        I, I, I, I, I, I,         # is_double, m, dist, bsf, philox, N
        L, I, I,                  # B, S, kk
        P, P, P, P, P, P, P,      # ytilde, Htilde, scales, ahat, Lb, Ab, sysb
        P, L, P, L, P, L, L,      # y, u, D (+strides)
        P, P, P, P, P, P]         # zphi, eps, us, key, out, stream
    lib.bssm_philox_fill.restype = I
    lib.bssm_philox_fill.argtypes = [I, I, L, I, I, P, P, P, P]
    lib.bssm_error_string.restype = ctypes.c_char_p
    lib.bssm_error_string.argtypes = [I]
    _lib = lib
    return lib


def _check_launch(lib, code: int, name: str) -> None:
    if code == 0:
        return
    if code < 0:
        raise RuntimeError(f"{name}: arguments outside the kernel's contract "
                           f"(code {code})")
    raise RuntimeError(f"{name}: kernel launch failed: "
                       f"{lib.bssm_error_string(code).decode()}")


# ---------------------------------------------------------------------------
# input checks and packing (plain Python, reached by the CPU tests too)
# ---------------------------------------------------------------------------

def _batch(spec) -> int:
    return spec.batch or 1


def _check_system(spec) -> None:
    m = spec.m
    if m > MAX_M:
        raise NotImplementedError(f"kernels support m <= {MAX_M}, got {m}")
    for name, nd in (("Z", 2), ("T", 3), ("R", 3), ("C", 2)):
        if with_batch(getattr(spec, name), nd).shape[1] != 1:
            raise NotImplementedError(
                f"kernels need a time-invariant {name}")


def _check_tensors(tensors, ref: torch.Tensor) -> None:
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32 or float64, got {ref.dtype}")
    for name, x in tensors:
        if x.device != ref.device:
            raise ValueError(f"{name} lies on {x.device}, expected "
                             f"{ref.device}")
        if x.dtype != ref.dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, expected "
                            f"{ref.dtype}")


def pack_system(spec, B: int, with_phi: bool) -> torch.Tensor:
    """The time-invariant system as one ``(rows, B)`` tensor, rows =
    [Z (m), T (m^2), RR (m^2), a1 (m), P1 (m^2), C (m)] (+ [phi]): batch
    innermost so that neighbouring threads read neighbouring addresses."""
    R = with_batch(spec.R, 3)[:, 0]
    leaves = [with_batch(spec.Z, 2)[:, 0], with_batch(spec.T, 3)[:, 0],
              R @ R.transpose(-1, -2), with_batch(spec.a1, 1),
              with_batch(spec.P1, 2), with_batch(spec.C, 2)[:, 0]]
    if with_phi:
        leaves.append(with_batch(spec.phi, 0))
    rows = [x.reshape(x.shape[0], -1).expand(B, -1).T for x in leaves]
    return torch.cat(rows, dim=0).contiguous()


def _series(x: torch.Tensor, B: int, name: str):
    """(tensor, batch stride, time stride) of a per-time leaf ``(nt,)`` or
    ``(b, nt)`` with nt in {1, n}: a shared leaf gets batch stride 0, a
    constant one time stride 0."""
    x = with_batch(x, 1)
    if x.shape[0] not in (1, B):
        raise ValueError(f"{name}: batch {x.shape[0]} does not match {B}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    nt = x.shape[1]
    return x, (nt if x.shape[0] > 1 else 0), (1 if nt > 1 else 0)


def _dense(x: torch.Tensor, shape, name: str) -> torch.Tensor:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x


def _series_time_major(x: torch.Tensor, B: int, name: str):
    """As ``_series``, with a series that varies over rows and time laid out
    time-major ``(n, B)`` (batch stride 1, time stride B)."""
    x, bs, ts = _series(x, B, name)
    if bs and ts:
        return x.T.contiguous(), 1, B
    return x, bs, ts


def _zphi(spec, B: int) -> torch.Tensor:
    """``(B, m + 1)`` rows [Z, phi] of the time-invariant observation
    vector and the family's auxiliary parameter."""
    return torch.cat([with_batch(spec.Z, 2)[:, 0].expand(B, spec.m),
                      with_batch(spec.phi, 0).expand(B)[:, None]],
                     dim=1).contiguous()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# K6 / K7: Kalman log-likelihood and fast smoother of linear-Gaussian models
# ---------------------------------------------------------------------------

def _lg_launch(name: str, g: LGSpec, smooth: bool):
    """Checks, packs and launches one of the two linear-Gaussian kernels;
    returns ``ll`` or ``(alpha, ll)``, the log-likelihood before the
    degenerate-model rule."""
    _check_system(g)
    B, n, m = _batch(g), g.n, g.m
    dt, dev = g.y.dtype, g.y.device
    _check_tensors([("H", g.H), ("D", g.D), ("Z", g.Z), ("T", g.T),
                    ("R", g.R), ("a1", g.a1), ("P1", g.P1), ("C", g.C)], g.y)
    series = []
    for nm, x in (("y", g.y), ("H^2", g.HH), ("D", g.D)):
        x, bs, ts = _series_time_major(x, B, nm)
        series += [x, bs, ts]
    args = [a.data_ptr() if torch.is_tensor(a) else a for a in series]
    sys_t = pack_system(g, B, with_phi=False)
    ll = torch.empty((B,), dtype=dt, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        if smooth:
            alpha = torch.empty((B, n + 1, m), dtype=dt, device=dev)
            scratch = torch.empty((n, 3 + m + m * m, B), dtype=dt, device=dev)
            code = lib.bssm_fast_smoother_ll(
                int(dt == torch.float64), m, B, n, *args, sys_t.data_ptr(),
                alpha.data_ptr(), ll.data_ptr(), scratch.data_ptr(),
                THREADS_PER_ROW_BLOCK, _stream(dev))
        else:
            code = lib.bssm_kalman_ll(
                int(dt == torch.float64), m, B, n, *args, sys_t.data_ptr(),
                ll.data_ptr(), THREADS_PER_ROW_BLOCK, _stream(dev))
    _check_launch(lib, code, name)
    LAUNCHES[name] += 1
    return (alpha, ll) if smooth else ll


def log_likelihood(g: LGSpec) -> torch.Tensor:
    """Kalman log-likelihood ``(B,)`` of every batch row of the
    linear-Gaussian model ``g``: the target of linear-Gaussian MCMC.  A row
    is degenerate (-inf) by the rule of the JAX package's kernel wrapper,
    ``ops/kalman.degenerate_h2rr``, on either device."""
    from . import kalman
    if not g.y.is_cuda:
        return kalman.log_likelihood(g, degenerate=kalman.degenerate_h2rr)
    ll = _lg_launch("log_likelihood", g, smooth=False)
    return torch.where(kalman.degenerate_h2rr(g),
                       torch.full_like(ll, -torch.inf), ll)


def fast_smoother_ll(g: LGSpec):
    """``(alpha (B, n+1, m), ll (B,))``: smoothed state means by the moment
    identity alphahat_t = a_t + P_t r_{t-1}, and the Kalman log-likelihood
    under the rule of ``log_likelihood``."""
    from . import kalman
    if not g.y.is_cuda:
        return kalman.fast_smoother_ll(g, degenerate=kalman.degenerate_h2rr)
    alpha, ll = _lg_launch("fast_smoother_ll", g, smooth=True)
    return alpha, torch.where(kalman.degenerate_h2rr(g),
                              torch.full_like(ll, -torch.inf), ll)


# ---------------------------------------------------------------------------
# K1: whole Laplace mode iteration
# ---------------------------------------------------------------------------

def _laplace_inputs(name: str, spec: NGSpec, mode: torch.Tensor, B: int):
    """Checks of the two Laplace kernels; returns the launch arguments of
    the series y, u, D and the mode (pointer, batch stride [, time stride])
    and the packed system."""
    _check_system(spec)
    if not SVM <= spec.distribution <= GAMMA:
        raise NotImplementedError(
            f"{name}: unsupported family {spec.distribution}")
    if spec.batch not in (None, 1, B):
        raise ValueError(f"{name}: spec batch {spec.batch} does not match "
                         f"the {B} rows of the mode")
    _check_tensors([("u", spec.u), ("D", spec.D), ("mode", mode),
                    ("Z", spec.Z), ("T", spec.T), ("R", spec.R),
                    ("a1", spec.a1), ("P1", spec.P1), ("C", spec.C),
                    ("phi", spec.phi)], spec.y)
    y, y_bs, _ = _series(spec.y, B, "y")
    u, u_bs, _ = _series(spec.u, B, "u")
    D, D_bs, D_ts = _series(spec.D, B, "D")
    mode, m_bs, _ = _series(mode, B, "mode")
    if mode.shape[1] != spec.n or u.shape[1] != spec.n:
        raise ValueError(f"{name}: u and the mode must have the length of y")
    series = [y.data_ptr(), y_bs, u.data_ptr(), u_bs, D.data_ptr(), D_bs,
              D_ts, mode.data_ptr(), m_bs]
    return series, pack_system(spec, B, with_phi=True)


def laplace_solve(spec: NGSpec, mode0: torch.Tensor, conv_tol: float,
                  max_iter: int):
    """Laplace mode iteration of every batch row, to per-row convergence.

    Returns ``(mode (B, n), prev (B, n), niter (B,) int32, diff (B,),
    ll (B,))``: the converged signal mode, the mode the last pass linearised
    at, the passes used, the last mean-squared change and the Kalman
    log-likelihood of the last pass's approximating model."""
    if not spec.y.is_cuda:
        from ..inference.approx import laplace_solve_plain
        return laplace_solve_plain(spec, mode0, conv_tol, max_iter)
    B, n, m = _batch(spec), spec.n, spec.m
    dt, dev = spec.y.dtype, spec.y.device
    series, sys_t = _laplace_inputs("laplace_solve", spec, mode0, B)
    mode = torch.empty((B, n), dtype=dt, device=dev)
    prev = torch.empty((B, n), dtype=dt, device=dev)
    ll = torch.empty((B,), dtype=dt, device=dev)
    diff = torch.empty((B,), dtype=dt, device=dev)
    niter = torch.empty((B,), dtype=torch.int32, device=dev)
    scratch = torch.empty((n, 5 + m + m * m, B), dtype=dt, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        code = lib.bssm_laplace_solve(
            int(dt == torch.float64), m, int(spec.distribution), B, n,
            *series, sys_t.data_ptr(), float(conv_tol), int(max_iter),
            mode.data_ptr(), prev.data_ptr(), ll.data_ptr(),
            niter.data_ptr(), diff.data_ptr(), scratch.data_ptr(),
            THREADS_PER_ROW_BLOCK, _stream(dev))
    _check_launch(lib, code, "laplace_solve")
    LAUNCHES["laplace_solve"] += 1
    return mode, prev, niter, diff, ll


# ---------------------------------------------------------------------------
# K8: one pass of the Laplace iteration
# ---------------------------------------------------------------------------

def laplace_step(spec: NGSpec, mode: torch.Tensor):
    """One pass of the Laplace iteration at ``mode (B, n)`` for every batch
    row: ``(new_mode (B, n), ll (B,), diff (B,))``, the new signal mode, the
    Kalman log-likelihood of the approximating model at the pseudo-
    observations of ``mode``, and the mean-squared change of the mode.  The
    spec may be unbatched (one model, B rows of modes) or have B rows."""
    if not spec.y.is_cuda:
        from ..inference.approx import _laplace_step
        return _laplace_step(spec, mode)
    B, n, m = with_batch(mode, 1).shape[0], spec.n, spec.m
    dt, dev = spec.y.dtype, spec.y.device
    series, sys_t = _laplace_inputs("laplace_step", spec, mode, B)
    new_mode = torch.empty((B, n), dtype=dt, device=dev)
    ll = torch.empty((B,), dtype=dt, device=dev)
    diff = torch.empty((B,), dtype=dt, device=dev)
    scratch = torch.empty((n, 3 + m + m * m, B), dtype=dt, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        code = lib.bssm_laplace_step(
            int(dt == torch.float64), m, int(spec.distribution), B, n,
            *series, sys_t.data_ptr(), new_mode.data_ptr(), ll.data_ptr(),
            diff.data_ptr(), scratch.data_ptr(), THREADS_PER_ROW_BLOCK,
            _stream(dev))
    _check_launch(lib, code, "laplace_step")
    LAUNCHES["laplace_step"] += 1
    return new_mode, ll, diff


# ---------------------------------------------------------------------------
# K2: Kalman filter + backward (FFBS) proposal factors
# ---------------------------------------------------------------------------

def rts_factors(g: LGSpec):
    """``(ahat (B, n+1, m), Lb (B, n+1, m, m), Ab (B, n+1, m, m))`` of the
    linear-Gaussian model ``g``; see ``ops/kalman.smoother_bwd_factors``."""
    if not g.y.is_cuda:
        from .kalman import smoother_bwd_factors
        return smoother_bwd_factors(g)
    _check_system(g)
    B, n, m = _batch(g), g.n, g.m
    dt, dev = g.y.dtype, g.y.device
    _check_tensors([("H", g.H), ("D", g.D), ("Z", g.Z), ("T", g.T),
                    ("R", g.R), ("a1", g.a1), ("P1", g.P1), ("C", g.C)], g.y)
    y, y_bs, _ = _series(g.y, B, "y")
    H, H_bs, H_ts = _series(g.H, B, "H")
    D, D_bs, D_ts = _series(g.D, B, "D")
    sys_t = pack_system(g, B, with_phi=False)
    ahat = torch.empty((B, n + 1, m), dtype=dt, device=dev)
    Lb = torch.empty((B, n + 1, m, m), dtype=dt, device=dev)
    Ab = torch.empty((B, n + 1, m, m), dtype=dt, device=dev)
    scratch = torch.empty((n, m + m * m, B), dtype=dt, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        code = lib.bssm_rts_factors(
            int(dt == torch.float64), m, B, n, y.data_ptr(), y_bs,
            H.data_ptr(), H_bs, H_ts, D.data_ptr(), D_bs, D_ts,
            sys_t.data_ptr(), ahat.data_ptr(), Lb.data_ptr(), Ab.data_ptr(),
            scratch.data_ptr(), THREADS_PER_ROW_BLOCK, _stream(dev))
    _check_launch(lib, code, "rts_factors")
    LAUNCHES["rts_factors"] += 1
    return ahat, Lb, Ab


# ---------------------------------------------------------------------------
# K3: psi-APF log-weight, N <= 32
# ---------------------------------------------------------------------------

def psi_logw(spec: NGSpec, al, ahat: torch.Tensor, Lb: torch.Tensor,
             Ab: torch.Tensor, eps: torch.Tensor,
             us: torch.Tensor) -> torch.Tensor:
    """psi-APF log-weight ``(B,)`` of every batch row from the proposal
    factors and injected randomness ``eps (B, n+1, N, m)``, ``us (B, n, N)``.
    ``al`` is the row's ``ApproxLoglik`` (mode, ytilde, Htilde, scales)."""
    if not spec.y.is_cuda:
        from ..inference.particle import psi_logw_scan
        return psi_logw_scan(spec, al, eps, us, factors=(ahat, Lb, Ab))
    _check_system(spec)
    if not SVM <= spec.distribution <= GAMMA:
        raise NotImplementedError(
            f"psi_logw: unsupported family {spec.distribution}")
    B, n, m = eps.shape[0], spec.n, spec.m
    N = eps.shape[2]
    if N > MAX_N_PSI:
        raise NotImplementedError(
            f"psi_logw handles N <= {MAX_N_PSI} particles, got {N}")
    if spec.batch not in (None, 1, B):
        raise ValueError("spec batch does not match eps")
    dt, dev = spec.y.dtype, spec.y.device
    yt, Ht, sc = al.approx.ytilde, al.approx.Htilde, al.scales
    _check_tensors([("u", spec.u), ("D", spec.D), ("Z", spec.Z),
                    ("phi", spec.phi), ("ytilde", yt), ("Htilde", Ht),
                    ("scales", sc), ("ahat", ahat), ("Lb", Lb), ("Ab", Ab),
                    ("eps", eps), ("us", us)], spec.y)
    y, y_bs, _ = _series(spec.y, B, "y")
    u, u_bs, _ = _series(spec.u, B, "u")
    D, D_bs, D_ts = _series(spec.D, B, "D")
    yt = _dense(yt, (B, n), "ytilde")
    Ht = _dense(Ht, (B, n), "Htilde")
    sc = _dense(sc, (B, n), "scales")
    ahat = _dense(ahat, (B, n + 1, m), "ahat")
    Lb = _dense(Lb, (B, n + 1, m, m), "Lb")
    Ab = _dense(Ab, (B, n + 1, m, m), "Ab")
    eps = _dense(eps, (B, n + 1, N, m), "eps")
    us = _dense(us, (B, n, N), "us")
    zphi = _zphi(spec, B)
    logw = torch.empty((B,), dtype=dt, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        code = lib.bssm_psi_logw(
            int(dt == torch.float64), m, int(spec.distribution), N, B, n,
            yt.data_ptr(), Ht.data_ptr(), y.data_ptr(), y_bs, u.data_ptr(),
            u_bs, sc.data_ptr(), D.data_ptr(), D_bs, D_ts, zphi.data_ptr(),
            ahat.data_ptr(), Lb.data_ptr(), Ab.data_ptr(), eps.data_ptr(),
            us.data_ptr(), logw.data_ptr(), THREADS_PSI_BLOCK, _stream(dev))
    _check_launch(lib, code, "psi_logw")
    LAUNCHES["psi_logw"] += 1
    return logw


# ---------------------------------------------------------------------------
# Philox keys and the tensors the Philox mode consumes
# ---------------------------------------------------------------------------

def philox_key(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """A fresh Philox key: two 32-bit words in an int64 ``(2,)`` tensor on
    ``device``, drawn from ``generator`` without a host synchronisation.
    Every call advances the generator, so successive calls (chunks of a
    correction, iterations of a chain) get independent streams."""
    return torch.randint(0, 2 ** 32, (2,), dtype=torch.int64, device=device,
                         generator=generator)


def _check_key(key: torch.Tensor, device) -> torch.Tensor:
    if key.dtype != torch.int64 or tuple(key.shape) != (2,):
        raise TypeError("a Philox key is an int64 tensor of shape (2,)")
    if key.device != device:
        raise ValueError(f"key lies on {key.device}, expected {device}")
    return key.contiguous()


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of the product of the 32-bit constant ``a``
    and the 32-bit words ``b`` (held in int64), without leaving int64."""
    p0 = (b & 0xFFFF) * a                 # < 2^48
    p1 = (b >> 16) * a                    # < 2^48
    lo = ((p0 & 0xFFFFFFFF) + ((p1 & 0xFFFF) << 16)) & 0xFFFFFFFF
    hi = ((p0 >> 16) + p1) >> 16
    return hi, lo


def philox4x32_10(ctr, key):
    """Philox-4x32-10 on int64 tensors holding 32-bit words: ``ctr`` a list
    of four broadcastable tensors, ``key`` of two.  Returns four words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & 0xFFFFFFFF
        k1 = (k1 + 0xBB67AE85) & 0xFFFFFFFF
    return c0, c1, c2, c3


def _u01(w: torch.Tensor, dtype) -> torch.Tensor:
    """(b + 0.5) / 2^24 from the top 24 bits, rounded once to ``dtype`` and
    kept strictly below 1."""
    u = (((w >> 8).to(torch.float64) + 0.5) / float(1 << 24)).to(dtype)
    one = torch.ones((), dtype=dtype, device=w.device)
    return torch.minimum(u, torch.nextafter(one, torch.zeros_like(one)))


def philox_fill_plain(key: torch.Tensor, B: int, steps: int, N: int, m: int,
                      dtype):
    """Plain version of ``philox_fill``: the same counter layout (particle,
    step, row, which) in tensor code.  Words 0 and 1 of the call with
    which = 0 feed normals 0 and 1.  For m <= 2 its word 2 feeds the
    resampling uniform; for m > 2 words 2 and 3 feed normals 2 and 3 and the
    uniform is word 0 of a second call, which = 1."""
    dev = key.device
    k = (key[0] & 0xFFFFFFFF, key[1] & 0xFFFFFFFF)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)  # noqa: E731
    row, step, part = ar(B)[:, None, None], ar(steps)[None, :, None], \
        ar(N)[None, None, :]
    zero = torch.zeros((B, steps, N), dtype=torch.int64, device=dev)
    ctr = [part + zero, step + zero, row + zero]
    w = philox4x32_10(ctr + [zero], k)
    zs = []
    for a, b in ((w[0], w[1]), (w[2], w[3]))[:(m + 1) // 2]:
        rad = torch.sqrt(-2.0 * torch.log(_u01(a, dtype)))
        ang = 2.0 * torch.pi * _u01(b, dtype)
        zs += [rad * torch.cos(ang), rad * torch.sin(ang)]
    eps = torch.stack(zs[:m], dim=-1).contiguous()
    wu = w[2] if m <= 2 else philox4x32_10(ctr + [zero + 1], k)[0]
    us = _u01(wu, dtype)[:, 1:].contiguous()
    return eps, us


def philox_fill(key: torch.Tensor, B: int, steps: int, N: int, m: int,
                dtype):
    """``(eps (B, steps, N, m), us (B, steps - 1, N))``: the standard
    normals and the resampling uniforms that the Philox mode of
    ``psi_big_logw`` / ``bsf_big_logw`` consumes for ``key`` (``us[:, s-1]``
    belongs to generation step ``s``)."""
    if not key.is_cuda:
        return philox_fill_plain(key, B, steps, N, m, dtype)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32 or float64, got {dtype}")
    if not 1 <= m <= MAX_M or steps < 1:
        raise ValueError("philox_fill: need 1 <= m <= 4 and steps >= 1")
    dev = key.device
    key = _check_key(key, dev)
    eps = torch.empty((B, steps, N, m), dtype=dtype, device=dev)
    us = torch.empty((B, steps - 1, N), dtype=dtype, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        code = lib.bssm_philox_fill(
            int(dtype == torch.float64), m, B, steps - 1, N, key.data_ptr(),
            eps.data_ptr(), us.data_ptr(), _stream(dev))
    _check_launch(lib, code, "philox_fill")
    LAUNCHES["philox_fill"] += 1
    return eps, us


# ---------------------------------------------------------------------------
# K4 / K5: the large-ensemble particle kernel, psi mode and bootstrap mode
# ---------------------------------------------------------------------------

def _randomness(name, B, steps, m, dev, eps, us, seed, nsim):
    """Checks the randomness arguments of the large-ensemble wrappers.
    Returns ``(N, eps, us, key)`` with either the stream tensors or the key
    set.  ``steps`` counts the initial draw."""
    if (eps is None) != (us is None) or (eps is None) == (seed is None):
        raise ValueError(f"{name}: give either eps and us, or seed")
    if eps is not None:
        N = eps.shape[2]
        eps = _dense(eps, (B, steps, N, m), "eps")
        us = _dense(us, (B, steps - 1, N), "us")
        key = None
    else:
        if nsim is None:
            raise ValueError(f"{name}: seed needs nsim, the particle count")
        N, key = int(nsim), _check_key(seed, dev)
    if not 2 <= N <= MAX_N_BIG:
        raise NotImplementedError(
            f"{name} handles 2 <= N <= {MAX_N_BIG} particles, got {N}")
    return N, eps, us, key


def _launch_big(name, spec, bsf, B, N, S, kk, psi_t, sysb, eps, us, key):
    """Shared launch of the two modes; ``psi_t`` = (ytilde, Htilde, scales,
    ahat, Lb, Ab) or None, ``sysb`` the packed bootstrap system or None."""
    m = spec.m
    dt, dev = spec.y.dtype, spec.y.device
    y, y_bs, _ = _series(spec.y, B, "y")
    u, u_bs, _ = _series(spec.u, B, "u")
    D, D_bs, D_ts = _series(spec.D, B, "D")
    zphi = _zphi(spec, B)
    out = torch.empty((B,), dtype=dt, device=dev)
    ptr = lambda x: 0 if x is None else x.data_ptr()        # noqa: E731
    psi_ptrs = [0] * 6 if psi_t is None else [x.data_ptr() for x in psi_t]
    lib = _load()
    with torch.cuda.device(dev):
        code = lib.bssm_particle_big(
            int(dt == torch.float64), m, int(spec.distribution), int(bsf),
            int(key is not None), N, B, S, int(kk), *psi_ptrs, ptr(sysb),
            y.data_ptr(), y_bs, u.data_ptr(), u_bs, D.data_ptr(), D_bs, D_ts,
            zphi.data_ptr(), ptr(eps), ptr(us), ptr(key), out.data_ptr(),
            _stream(dev))
    _check_launch(lib, code, name)
    LAUNCHES[name] += 1
    return out


def _check_big(name, spec, kk) -> None:
    _check_system(spec)
    if not SVM <= spec.distribution <= GAMMA:
        raise NotImplementedError(
            f"{name}: unsupported family {spec.distribution}")
    if int(kk) < 1:
        raise ValueError(f"{name}: the resampling period must be >= 1")


def psi_big_logw(spec: NGSpec, al, ahat: torch.Tensor, Lb: torch.Tensor,
                 Ab: torch.Tensor, kk: int, *, eps=None, us=None, seed=None,
                 nsim: Optional[int] = None) -> torch.Tensor:
    """psi-APF log-weight ``(B,)`` of every batch row with 2 <= N <= 512
    particles, resampling at every ``kk``-th step.  Randomness: either
    injected ``eps (B, n+1, N, m)`` and ``us (B, n, N)``, or ``seed``, a
    Philox key (``philox_key``), together with ``nsim`` = N."""
    B, n, m = al.approx.mode.shape[0], spec.n, spec.m
    N, eps, us, key = _randomness("psi_big_logw", B, n + 1, m,
                                  spec.y.device, eps, us, seed, nsim)
    if not spec.y.is_cuda:
        from ..inference.particle import psi_logw_scan
        if eps is None:
            eps, us = philox_fill_plain(key, B, n + 1, N, m, spec.y.dtype)
        return psi_logw_scan(spec, al, eps, us, factors=(ahat, Lb, Ab),
                             resample_every=kk)
    _check_big("psi_big_logw", spec, kk)
    if spec.batch not in (None, 1, B):
        raise ValueError("spec batch does not match the approximation")
    dt, dev = spec.y.dtype, spec.y.device
    yt, Ht, sc = al.approx.ytilde, al.approx.Htilde, al.scales
    named = [("u", spec.u), ("D", spec.D), ("Z", spec.Z), ("phi", spec.phi),
             ("ytilde", yt), ("Htilde", Ht), ("scales", sc), ("ahat", ahat),
             ("Lb", Lb), ("Ab", Ab)]
    if eps is not None:
        named += [("eps", eps), ("us", us)]
    _check_tensors(named, spec.y)
    psi_t = (_dense(yt, (B, n), "ytilde"), _dense(Ht, (B, n), "Htilde"),
             _dense(sc, (B, n), "scales"),
             _dense(ahat, (B, n + 1, m), "ahat"),
             _dense(Lb, (B, n + 1, m, m), "Lb"),
             _dense(Ab, (B, n + 1, m, m), "Ab"))
    return _launch_big("psi_big_logw", spec, False, B, N, n, kk, psi_t, None,
                       eps, us, key)


def pack_bootstrap_system(spec: NGSpec, B: int) -> torch.Tensor:
    """``(B, 2m + 3m^2)`` rows [a1, chol(P1), C, R, T] of the time-invariant
    system, R zero-padded to m columns (more columns than states are not
    served)."""
    from .chol import psd_chol
    m = spec.m
    R = with_batch(spec.R, 3)[:, 0]
    k = R.shape[-1]
    if k > m:
        raise NotImplementedError(
            f"bsf_big_logw: R has {k} columns, more than the {m} states")
    if k < m:
        R = torch.cat([R, R.new_zeros(R.shape[0], m, m - k)], dim=-1)
    leaves = [with_batch(spec.a1, 1), psd_chol(with_batch(spec.P1, 2)),
              with_batch(spec.C, 2)[:, 0], R, with_batch(spec.T, 3)[:, 0]]
    return torch.cat([x.reshape(x.shape[0], -1).expand(B, -1)
                      for x in leaves], dim=1).contiguous()


def bsf_big_logw(spec: NGSpec, kk: int, *, eps=None, us=None, seed=None,
                 nsim: Optional[int] = None) -> torch.Tensor:
    """Bootstrap-filter log-likelihood ``(B,)`` less the observation
    constants, 2 <= N <= 512 particles, resampling at every ``kk``-th step.
    Randomness: either injected ``eps (B, n, N, m)`` and ``us (B, n-1, N)``,
    or ``seed`` (a Philox key) with ``nsim``; B is then the batch size of
    ``spec``."""
    n, m = spec.n, spec.m
    B = eps.shape[0] if eps is not None else _batch(spec)
    N, eps, us, key = _randomness("bsf_big_logw", B, n, m, spec.y.device,
                                  eps, us, seed, nsim)
    if not spec.y.is_cuda:
        from ..inference.particle import bsf_logw_scan
        if eps is None:
            eps, us = philox_fill_plain(key, B, n, N, m, spec.y.dtype)
        return bsf_logw_scan(spec, eps, us, resample_every=kk)
    _check_big("bsf_big_logw", spec, kk)
    if spec.batch not in (None, 1, B):
        raise ValueError("spec batch does not match eps")
    dt, dev = spec.y.dtype, spec.y.device
    named = [("u", spec.u), ("D", spec.D), ("Z", spec.Z), ("phi", spec.phi),
             ("T", spec.T), ("R", spec.R), ("a1", spec.a1), ("P1", spec.P1),
             ("C", spec.C)]
    if eps is not None:
        named += [("eps", eps), ("us", us)]
    _check_tensors(named, spec.y)
    sysb = pack_bootstrap_system(spec, B)
    return _launch_big("bsf_big_logw", spec, True, B, N, n - 1, kk, None,
                       sysb, eps, us, key)
