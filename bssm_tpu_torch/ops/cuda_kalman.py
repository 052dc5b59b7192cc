"""Hand-written CUDA kernels of the state-space hot paths, their build and
their wrappers.  Counterpart of ``bssm_tpu/ops/pallas_kalman.py``.

Three kernels (sources in ``bssm_tpu_torch/csrc/``, CUDA C++ for sm_90a):

===============  ======================  ===================================
wrapper          source                  plain version
===============  ======================  ===================================
laplace_solve    csrc/laplace_solve.cu   inference/approx.laplace_solve_plain
rts_factors      csrc/rts_factors.cu     ops/kalman.smoother_bwd_factors
psi_logw         csrc/psi_logw.cu        inference/particle.psi_logw_scan
===============  ======================  ===================================

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
# Threads per block.  The row-per-thread kernels use blocks of one warp so
# that a few thousand rows still spread over every SM; psi_logw gives each
# row a warp, four rows to a block.
THREADS_PER_ROW_BLOCK = 32
THREADS_PSI_BLOCK = 128

# launches of each kernel since the last reset_launch_counts()
LAUNCHES = {"laplace_solve": 0, "rts_factors": 0, "psi_logw": 0}

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
    lib.bssm_laplace_solve.restype = I
    lib.bssm_laplace_solve.argtypes = [
        I, I, I, L, I,            # is_double, m, dist, B, n
        P, L, P, L, P, L, L,      # y, u, D (+strides)
        P, L, P,                  # mode0 (+stride), sys
        Dbl, I,                   # conv_tol, max_iter
        P, P, P, P, P, P,         # mode, prev, ll, niter, diff, scratch
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


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# K1: whole Laplace mode iteration
# ---------------------------------------------------------------------------

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
    _check_system(spec)
    if not SVM <= spec.distribution <= GAMMA:
        raise NotImplementedError(
            f"laplace_solve: unsupported family {spec.distribution}")
    B, n, m = _batch(spec), spec.n, spec.m
    dt, dev = spec.y.dtype, spec.y.device
    _check_tensors([("u", spec.u), ("D", spec.D), ("mode0", mode0),
                    ("Z", spec.Z), ("T", spec.T), ("R", spec.R),
                    ("a1", spec.a1), ("P1", spec.P1), ("C", spec.C),
                    ("phi", spec.phi)], spec.y)
    y, y_bs, _ = _series(spec.y, B, "y")
    u, u_bs, _ = _series(spec.u, B, "u")
    D, D_bs, D_ts = _series(spec.D, B, "D")
    mode0, m0_bs, _ = _series(mode0, B, "mode0")
    if mode0.shape[1] != n or u.shape[1] != n:
        raise ValueError("u and mode0 must have the length of y")
    sys_t = pack_system(spec, B, with_phi=True)
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
            y.data_ptr(), y_bs, u.data_ptr(), u_bs, D.data_ptr(), D_bs, D_ts,
            mode0.data_ptr(), m0_bs, sys_t.data_ptr(), float(conv_tol),
            int(max_iter), mode.data_ptr(), prev.data_ptr(), ll.data_ptr(),
            niter.data_ptr(), diff.data_ptr(), scratch.data_ptr(),
            THREADS_PER_ROW_BLOCK, _stream(dev))
    _check_launch(lib, code, "laplace_solve")
    LAUNCHES["laplace_solve"] += 1
    return mode, prev, niter, diff, ll


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
    zphi = torch.cat([with_batch(spec.Z, 2)[:, 0].expand(B, m),
                      with_batch(spec.phi, 0).expand(B)[:, None]],
                     dim=1).contiguous()
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
