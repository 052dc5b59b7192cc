"""Hand-written CUDA kernels of the state-space hot paths, their build and
their wrappers.  Counterpart of ``bssm_tpu/ops/pallas_kalman.py``.

Sources in ``bssm_tpu_torch/csrc/`` (CUDA C++ for sm_90a; the large-
ensemble kernel is one template, ``particle_big.cuh``, instantiated in four
sources beside its entry points), nine wrappers:

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
that the two modes can be compared; in stream mode a check may also inject
the ancestors (``anc``), so that the kernel and its plain version resample
alike.

Each wrapper checks its inputs, allocates outputs and scratch with
``torch.empty``, launches on PyTorch's current stream, checks the launch
error and raises, does not synchronise, and adds one to its entry of
``LAUNCHES``.  Given tensors on the CPU it calls the plain version; given
CUDA tensors it launches the kernel or raises.  Nothing falls back.

Routing.  The kernels take m <= ``MAX_M`` states and a time-invariant Z,
T, R and C (the bootstrap mode also no more columns of R than states),
as the JAX package's kernels do.  The call sites decide before any
wrapper, from the spec's shape alone (``kernel_takes``, through
``route``): a spec the kernel takes goes to the wrapper, any other to the
plain version on the tensors it already holds, on either device; a plain
route taken on the card adds one to ``PLAIN_ROUTES``, beside ``LAUNCHES``.
So a seasonal model with period 12 (m = 12 or 13) runs on the card through
the plain versions, as it runs through the JAX package's scans, and a
path that the kernels serve shows no plain route.

The kernels read the spec where it lies: every series as (pointer, batch
stride, time stride) (``_strided``), every time-invariant leaf as (pointer,
batch stride) (``system_leaves``), so no system is packed and no series is
transposed or copied; the kernels that need R R' form it themselves, and
every wrapper but ``philox_fill`` hands its arguments over as one packed
struct (``_call``).  The bootstrap mode, too, reads a1, C, T and R (by its
own column count) as leaves, with chol(P1) taken once per distinct P1
(``_p1_chol``); ``pack_bootstrap_system`` serves only its plain version.
The Kalman log-likelihood kernel applies the degenerate-model rule itself;
on the card ``log_likelihood``, ``laplace_solve`` and ``rts_factors`` (in
its shared-memory staging) are one allocation and one launch a call.

Build: at the first CUDA call, ``nvcc`` compiles every ``csrc/*.cu`` (one
process per source, started together) for ``sm_90a`` and links them into
``bssm_tpu_torch/_build/libbssm_kernels.so``, which is loaded with
``ctypes``.  The library is rebuilt when the hash of the sources changes.
Importing this module needs neither ``nvcc`` nor a GPU.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from ..core.spec import LGSpec, NGSpec, SVM, GAMMA, is_mv, with_batch
from ..diagnostics import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libbssm_kernels.so"

MAX_M = 4
MAX_N_PSI = 32
MAX_N_BIG = 512
# Threads per block.  The row-per-thread kernels use blocks of at most one
# warp so that a few thousand rows still spread over every SM; psi_logw
# gives each row a segment of a warp (``psi_segment``), four warps to a
# block.
THREADS_PER_ROW_BLOCK = 32
THREADS_PSI_BLOCK = 128
# dynamic shared memory a laplace_solve block may use on sm_90 (227 KB less
# the kernel's own 128 bytes), the shared memory of one SM (228 KB), what a
# block takes of it beside its dynamic share (the system's 1 KB and those
# 128 bytes), the most blocks an SM holds, and the budget of the
# log_likelihood kernel's D tile (inside the default 48 KB)
SMEM_LIMIT = 232448 - 128
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024 + 128
MAX_BLOCKS_PER_SM = 32
TILE_BYTES = 48 * 1024
# laplace_solve: the most waves of shared-staged blocks for which shared
# memory is chosen over device memory, where every row is resident at once;
# chip_smoke.py's staging sweep times both (PERF.md)
SHARED_WAVES = 1

# launches of each kernel since the last reset_launch_counts(); the three
# counts are counters of diagnostics/profiling.py too
LAUNCHES = profiling.register("launches", {
    "log_likelihood": 0, "fast_smoother_ll": 0, "laplace_solve": 0,
    "laplace_step": 0, "rts_factors": 0, "psi_logw": 0, "psi_big_logw": 0,
    "bsf_big_logw": 0, "philox_fill": 0})
# plain versions run on the card in place of each wrapper's kernel, for
# specs outside the kernels' contract (``route``), since the same reset
PLAIN_ROUTES = profiling.register(
    "plain_routes", {k: 0 for k in LAUNCHES if k != "philox_fill"})
# kernels run again by replays of a captured CUDA graph
# (``inference/replay.py``), counted apart from ``LAUNCHES``: a replay
# issues the graph, not the wrappers
REPLAYED = profiling.register("replayed", {k: 0 for k in LAUNCHES})

# seconds the last build took (None: library was already built or not loaded)
build_seconds: Optional[float] = None

_lib = None


def reset_launch_counts() -> None:
    """Sets ``LAUNCHES``, ``PLAIN_ROUTES`` and ``REPLAYED`` to 0."""
    for counts in (LAUNCHES, PLAIN_ROUTES, REPLAYED):
        for k in counts:
            counts[k] = 0


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
    P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    # the kernels that take a packed argument struct: (bytes, its length)
    for fn in (lib.bssm_kalman_ll, lib.bssm_fast_smoother_ll,
               lib.bssm_laplace_solve, lib.bssm_laplace_step,
               lib.bssm_rts_factors, lib.bssm_psi_logw,
               lib.bssm_particle_big):
        fn.restype = I
        fn.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.bssm_philox_fill.restype = I
    lib.bssm_philox_fill.argtypes = [I, I, L, I, I, L, P, P, P, P]
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


def _univariate(name: str, spec) -> None:
    """Every wrapper takes one observed series: a multivariate spec is
    refused on either device (the multivariate models reach no kernel;
    ``ops/kalman_mv``, ``inference/approx_mv``)."""
    if is_mv(spec):
        raise TypeError(f"{name}: the kernels take one observed series, got "
                        f"a {type(spec).__name__}")


def _outside_system(spec) -> Optional[str]:
    """Why the kernels cannot take the system of ``spec`` (several
    observed series, its state dimension or a time-varying Z, T, R or C),
    or None."""
    if is_mv(spec):
        return "kernels take one observed series"
    m = spec.m
    if m > MAX_M:
        return f"kernels support m <= {MAX_M}, got {m}"
    for name, nd in (("Z", 2), ("T", 3), ("R", 3), ("C", 2)):
        if getattr(spec, name).shape[-nd] != 1:
            return f"kernels need a time-invariant {name}"
    return None


def _check_system(spec) -> None:
    why = _outside_system(spec)
    if why is not None:
        raise NotImplementedError(why)


# the wrappers that take a non-Gaussian spec: they serve its five families
NG_WRAPPERS = ("laplace_solve", "laplace_step", "psi_logw", "psi_big_logw",
               "bsf_big_logw")


def kernel_takes(spec, wrapper: str) -> bool:
    """Whether the kernel behind ``wrapper`` takes ``spec``, decided from the
    spec's shape alone, before any wrapper is called: m <= ``MAX_M``, a
    time-invariant Z, T, R and C, for ``bsf_big_logw`` no more columns of R
    than states, and for the wrappers of non-Gaussian specs a non-Gaussian
    spec of one of the families they serve.  It mirrors the JAX package's decline of its
    kernels (``_batched_inputs``, ``fused_laplace_solve_batched``), after
    which that package runs its scans.  The wrappers' own refusal
    (``_check_system``) stays: a wrapper never falls back."""
    if wrapper not in PLAIN_ROUTES:
        raise ValueError(f"unknown kernel wrapper {wrapper!r}")
    if _outside_system(spec) is not None:
        return False
    if wrapper == "bsf_big_logw" and spec.k > spec.m:
        return False
    family = getattr(spec, "distribution", None)   # None: linear-Gaussian
    return wrapper not in NG_WRAPPERS or (family is not None
                                          and SVM <= family <= GAMMA)


def route(wrapper: str, spec) -> bool:
    """The call sites' dispatch: True where the kernel behind ``wrapper``
    takes ``spec`` (``kernel_takes``), so the caller calls the wrapper;
    False where it does not, so the caller runs the plain version on the
    tensors the spec already holds, and a spec on the card adds one to
    ``PLAIN_ROUTES[wrapper]``."""
    if kernel_takes(spec, wrapper):
        return True
    if spec.y.is_cuda:
        PLAIN_ROUTES[wrapper] += 1
    return False


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


# the leaves of the spec the kernels read: field -> (axes after the batch
# axis, whether the first of them is a time axis of size 1)
_LEAVES = {"Z": (2, True), "T": (3, True), "R": (3, True), "a1": (1, False),
           "P1": (2, False), "C": (2, True), "phi": (0, False)}
SYSTEM = ("Z", "T", "R", "a1", "P1", "C")


def _core_contiguous(shape, stride) -> bool:
    expect = 1
    for size, st in zip(reversed(shape), reversed(stride)):
        if size != 1 and st != expect:
            return False
        expect *= size
    return True


def system_leaves(spec, B: int, names=SYSTEM,
                  ref: Optional[torch.Tensor] = None):
    """The time-invariant leaves ``names`` (default the system Z, T, R, a1,
    P1, C; ``phi`` may be added) as the kernels read them: ``[(name, tensor,
    batch stride)]``, the spec's own tensors.  Element i of row b of a leaf
    is read at ``tensor.data_ptr()`` + (b * stride + i) elements, i running
    over the leaf's core (the axes after batch and time) in row-major order;
    a leaf shared by all rows, or an expand view, has stride 0.  A leaf is
    copied only when its core is not contiguous.  The kernels form R R'
    from R.  With ``ref`` each leaf's device and dtype are checked against
    it (``_check_tensors``)."""
    out = []
    for name in names:
        core, timed = _LEAVES[name]
        x = getattr(spec, name)
        if ref is not None and (x.dtype != ref.dtype
                                or x.device != ref.device):
            _check_tensors([(name, x)], ref)
        nb = x.dim() - core
        if nb not in (0, 1):
            raise ValueError(f"{name}: expected {core} or {core + 1} axes, "
                             f"got shape {tuple(x.shape)}")
        b = x.shape[0] if nb else 1
        if b not in (1, B):
            raise ValueError(f"{name}: batch {b} does not match {B}")
        if not x.is_contiguous():       # else its core is contiguous too
            start = nb + int(timed)
            if not _core_contiguous(x.shape[start:], x.stride()[start:]):
                x = x.contiguous()
        out.append((name, x, x.stride(0) if b > 1 else 0))
    return out


def _leaf_args(spec, B: int, names, ref: Optional[torch.Tensor] = None):
    """The ``LeafArg`` fields (pointer, batch stride) of the leaves
    ``names``, and the leaves, which the caller keeps alive until the
    launch; ``ref`` as for ``system_leaves``."""
    leaves = system_leaves(spec, B, names, ref)
    flat = []
    for _, x, bs in leaves:
        flat += [x.data_ptr(), bs]
    return flat, leaves


def _system_args(spec, B: int, with_phi: bool,
                 ref: Optional[torch.Tensor] = None):
    """The ``SystemArg`` fields of ``csrc/kalman_common.cuh`` (the leaves,
    phi's zero when absent, the columns of R) and the leaves to keep alive
    until the launch; ``ref`` as for ``system_leaves``."""
    flat, leaves = _leaf_args(spec, B, SYSTEM + (("phi",) if with_phi
                                                 else ()), ref)
    if not with_phi:
        flat += [0, 0]
    return flat + [spec.R.shape[-1]], leaves


def _strided(x: torch.Tensor, B: int, n: int, name: str,
             full: bool = False) -> list:
    """The ``SeriesArg`` fields ``[pointer, batch stride, time stride]`` of
    a per-time leaf ``(nt,)`` or ``(b, nt)``, b in {1, B}, nt in {1, n}
    (``full``: nt = n): the kernel reads value t of row b at
    ``x[b * bs + t * ts]``, whatever the strides, so nothing is copied; a
    shared leaf has bs = 0, a constant one ts = 0."""
    if x.dim() == 1:
        (nt,), (st_t,) = x.shape, x.stride()
        b, st_b = 1, 0
    elif x.dim() == 2:
        (b, nt), (st_b, st_t) = x.shape, x.stride()
    else:
        raise ValueError(f"{name}: expected 1 or 2 axes, got shape "
                         f"{tuple(x.shape)}")
    if b not in (1, B):
        raise ValueError(f"{name}: batch {b} does not match {B}")
    if nt != n and (full or nt != 1):
        raise ValueError(f"{name}: {nt} time points, expected {n}"
                         + ("" if full else " or 1"))
    return [x.data_ptr(), st_b if b > 1 else 0, st_t if nt > 1 else 0]


def _dense(x: torch.Tensor, shape: tuple, name: str,
           ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` after checking its shape and contiguity, and with ``ref`` its
    device and dtype (``_check_tensors``)."""
    if x.shape != shape or not x.is_contiguous() or ref is not None and (
            x.dtype != ref.dtype or x.device != ref.device):
        if x.shape != shape:
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        _check_tensors([(name, x)], ref)
    return x


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# the current stream of a device index as an integer, without a Stream
# object where this PyTorch offers it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def _launch(fn, layout: struct.Struct, dev, *fields) -> int:
    """Calls a C entry that takes its packed argument struct, whose last
    field is the stream: the current stream of ``dev``, with ``dev`` the
    current device during the call."""
    if dev.index == torch.cuda.current_device():
        return fn(layout.pack(*fields, _raw_stream(dev.index)), layout.size)
    with torch.cuda.device(dev):
        return fn(layout.pack(*fields, _raw_stream(dev.index)), layout.size)


# The argument structs of csrc/ (LaplaceArgs, StepArgs, KalmanArgs, RtsArgs,
# PsiArgs, BigLaunch), field for field: "q" a 64-bit integer or pointer, "d"
# a double.
_SOLVE_ARGS = struct.Struct("=32qd8q")
_STEP_ARGS = struct.Struct("=39q")
_KALMAN_ARGS = struct.Struct("=36q")
_RTS_ARGS = struct.Struct("=35q")
_PSI_ARGS = struct.Struct("=30q")
_BIG_ARGS = struct.Struct("=49q")


def _call(fn, layout: struct.Struct, *fields) -> int:
    """Calls a C entry that takes its packed argument struct."""
    return fn(layout.pack(*fields), layout.size)


# ---------------------------------------------------------------------------
# K6 / K7: Kalman log-likelihood and fast smoother of linear-Gaussian models
# ---------------------------------------------------------------------------

def kalman_tile(n: int, itemsize: int) -> tuple:
    """``(chunk, shared bytes)`` of the D tile of the ``log_likelihood``
    kernel, for an intercept that varies over rows and time: the block's
    ``THREADS_PER_ROW_BLOCK`` rows of D in shared memory, all n steps at
    once when that fits in ``TILE_BYTES``, else two buffers of the largest
    odd chunk that fits (a tile row's leading dimension is the chunk made
    odd)."""
    rows = THREADS_PER_ROW_BLOCK
    whole = rows * (n | 1) * itemsize
    if whole <= TILE_BYTES:
        return n, whole
    chunk = TILE_BYTES // (2 * rows * itemsize)
    chunk -= 1 - chunk % 2
    return chunk, 2 * rows * chunk * itemsize


# fast_smoother_ll and laplace_step (csrc/kalman_filter.cu,
# csrc/laplace_solve.cu): how a block lays out the forward pass that the
# split backward pass reads
FS_ROWS_SHARED = 8        # rows of a block holding their whole series
FS_THREADS = 128          # its threads
FS_ROWS_TILED = 32        # rows (and threads: one warp) of a block with
                          # tiles and checkpoints
FS_TILE_BYTES = 12 * 1024 # the most bytes of such a block's tile: 12
                          # steps at m = 2 float32, so that 16 blocks fit
                          # an SM and the path's 65536 rows run at once
# the most waves of whole-series blocks for which they are chosen over
# tiles with checkpoints, for fast_smoother_ll and for laplace_step, whose
# tiles cost more (its match runs again with each tile's forward steps):
# chip_smoke.py's fs_staging_sweep and step_staging_readings, PERF.md
FS_SHARED_WAVES = 2.5
STEP_SHARED_WAVES = 4.0


class FsGeometry(NamedTuple):
    """How ``fast_smoother_ll`` or ``laplace_step`` lays a launch out."""
    rows: int          # rows of the batch a block takes
    threads: int       # threads of a block
    chunk: int         # steps of a block's tile; n: the whole series, in
                       # shared memory (else tiles with checkpoints)
    smem_bytes: int    # dynamic shared memory of a block


def split_fields(m: int) -> int:
    """Values a step holds in the tile of the split backward pass
    (``split_fields`` of csrc/kalman_common.cuh): m + 1 backward slots,
    a_t, P_t's upper triangle."""
    return 2 * m + 1 + m * (m + 1) // 2


def fs_block_elems(rows: int, steps: int, m: int) -> int:
    """Shared values of a ``fast_smoother_ll`` block: each row's Z and T,
    then a tile of ``steps`` steps a row, each row's run made odd."""
    return rows * (m + m * m) + rows * ((split_fields(m) * steps) | 1)


def step_block_elems(rows: int, steps: int, m: int) -> int:
    """Shared values of a ``laplace_step`` block: those of
    ``fs_block_elems`` and each row's 32 partial sums of the change."""
    return fs_block_elems(rows, steps, m) + 32 * rows


def fs_chunk(n: int, m: int, itemsize: int) -> int:
    """Steps of the tile of a block with checkpoints: as many as
    ``FS_TILE_BYTES`` hold for its ``FS_ROWS_TILED`` rows, at least 1, at
    most n."""
    per_step = FS_ROWS_TILED * split_fields(m) * itemsize
    return max(1, min(n, FS_TILE_BYTES // per_step))


def fs_options(n: int, m: int, itemsize: int, step: bool = False,
               rows: int = FS_ROWS_SHARED) -> dict:
    """The two layouts of ``fast_smoother_ll`` (``step``: of
    ``laplace_step``) for series of length n, state dimension m and values
    of ``itemsize`` bytes: ``shared``, ``rows`` rows a block on
    ``FS_THREADS`` threads with their whole series in shared memory (None
    where they do not fit in ``SMEM_LIMIT``), and ``checkpoint``,
    ``FS_ROWS_TILED`` rows a block with tiles of ``fs_chunk`` steps."""
    elems = step_block_elems if step else fs_block_elems
    smem = elems(rows, n, m) * itemsize
    shared = FsGeometry(rows, FS_THREADS, n, smem) \
        if smem <= SMEM_LIMIT else None
    chunk = fs_chunk(n, m, itemsize)
    return {"shared": shared,
            "checkpoint": FsGeometry(FS_ROWS_TILED, FS_ROWS_TILED, chunk,
                                     elems(FS_ROWS_TILED, chunk, m)
                                     * itemsize)}


def fs_waves(geo: FsGeometry, B: int, sms: int) -> float:
    """Waves in which the blocks of ``geo`` run over B rows on ``sms``
    multiprocessors: as many blocks an SM as its shared memory (each with
    its reserve), its 64 warps and its block limit hold."""
    per_sm = min(MAX_BLOCKS_PER_SM, 64 // (geo.threads // 32),
                 SMEM_PER_SM // (geo.smem_bytes + SMEM_RESERVED))
    return -(-B // geo.rows) / (sms * per_sm)


@functools.lru_cache(maxsize=None)
def fs_geometry(n: int, m: int, itemsize: int, B: int, sms: int,
                step: bool = False) -> FsGeometry:
    """The launch of ``fast_smoother_ll`` (``step``: of ``laplace_step``)
    for B rows on a card of ``sms`` multiprocessors: whole series in shared
    memory while those blocks run in at most ``FS_SHARED_WAVES``
    (``STEP_SHARED_WAVES``) waves, each further wave costing a whole
    forward chain, else tiles with checkpoints, every row resident at once.
    One model (B = 1) takes one row a block.  Cached: a chain asks for the
    same launch at every iteration."""
    opts = fs_options(n, m, itemsize, step,
                      rows=1 if B == 1 else FS_ROWS_SHARED)
    shared = opts["shared"]
    most = STEP_SHARED_WAVES if step else FS_SHARED_WAVES
    if shared is not None and fs_waves(shared, B, sms) <= most:
        return shared
    return opts["checkpoint"]


def fs_scratch_elems(geo: FsGeometry, B: int, n: int, m: int) -> int:
    """Values of the checkpoints of a launch laid out as ``geo``: a and P's
    upper triangle at the start of every tile but the first, for B rows
    rounded up to whole blocks; none with one tile."""
    rows = -(-B // geo.rows) * geo.rows
    return rows * (m + m * (m + 1) // 2) * (-(-n // geo.chunk) - 1)


def _lg_launch(name: str, g: LGSpec, smooth: bool,
               staging: Optional[FsGeometry] = None):
    """Checks and launches one of the two linear-Gaussian kernels on the
    spec's own tensors; returns ``ll`` or ``(alpha, ll)``, with the
    degenerate-model rule applied by the kernel.  The smoother's outputs
    are views of one allocation, its launch laid out as ``fs_geometry``
    chooses unless ``staging`` says otherwise."""
    _check_system(g)
    B, n, m = _batch(g), g.n, g.m
    dt, dev = g.y.dtype, g.y.device
    _check_tensors([("H", g.H), ("D", g.D), ("Z", g.Z), ("T", g.T),
                    ("R", g.R), ("a1", g.a1), ("P1", g.P1), ("C", g.C)], g.y)
    D = _strided(g.D, B, n, "D")
    series = _strided(g.y, B, n, "y", full=True) \
        + _strided(g.H, B, n, "H") + D
    sys_args, keep = _system_args(g, B, with_phi=False)
    lib = _load()
    if smooth:
        geo = staging or fs_geometry(n, m, g.y.element_size(), B,
                                     _sm_count(dev.index))
        k = B * (n + 1) * m
        out = torch.empty((k + B,), dtype=dt, device=dev)
        alpha, ll = out[:k].view(B, n + 1, m), out[k:]
        size = fs_scratch_elems(geo, B, n, m)
        scratch = torch.empty((size,), dtype=dt, device=dev) if size \
            else None
        code = _launch(lib.bssm_fast_smoother_ll, _KALMAN_ARGS, dev,
                       int(dt == torch.float64), m, B, n, *series,
                       *sys_args, ll.data_ptr(), alpha.data_ptr(),
                       0 if scratch is None else scratch.data_ptr(),
                       geo.chunk, geo.smem_bytes, geo.rows, geo.threads)
    else:
        chunk, smem = kalman_tile(n, g.y.element_size()) \
            if D[1] and D[2] else (0, 0)
        ll = torch.empty((B,), dtype=dt, device=dev)
        code = _launch(lib.bssm_kalman_ll, _KALMAN_ARGS, dev,
                       int(dt == torch.float64), m, B, n, *series,
                       *sys_args, ll.data_ptr(), 0, 0, chunk, smem, 0, 0)
    _check_launch(lib, code, name)
    LAUNCHES[name] += 1
    return (alpha, ll) if smooth else ll


def log_likelihood(g: LGSpec) -> torch.Tensor:
    """Kalman log-likelihood ``(B,)`` of every batch row of the
    linear-Gaussian model ``g``: the target of linear-Gaussian MCMC.  A row
    is degenerate (-inf) by the rule of the JAX package's kernel wrapper,
    ``ops/kalman.degenerate_h2rr``, on either device; on the card the
    kernel applies it, and a call is one launch."""
    _univariate("log_likelihood", g)
    from . import kalman
    if not g.y.is_cuda:
        return kalman.log_likelihood(g, degenerate=kalman.degenerate_h2rr)
    return _lg_launch("log_likelihood", g, smooth=False)


def fast_smoother_ll(g: LGSpec, staging: Optional[FsGeometry] = None):
    """``(alpha (B, n+1, m), ll (B,))``: smoothed state means by the moment
    identity alphahat_t = a_t + P_t r_{t-1}, and the Kalman log-likelihood
    under the rule of ``log_likelihood``.  On the card a call is one launch,
    laid out as ``fs_geometry`` chooses unless ``staging`` (one of
    ``fs_options``) says otherwise: every layout gives the same bits."""
    _univariate("fast_smoother_ll", g)
    from . import kalman
    if not g.y.is_cuda:
        return kalman.fast_smoother_ll(g, degenerate=kalman.degenerate_h2rr)
    return _lg_launch("fast_smoother_ll", g, smooth=True, staging=staging)


def _plain_log_likelihood(g: LGSpec):
    from . import kalman
    return (kalman.log_likelihood(g, degenerate=kalman.degenerate_h2rr),)


def routed_log_likelihood(g: LGSpec, replay=None) -> torch.Tensor:
    """``log_likelihood`` at a call site: the kernel where it takes ``g``
    (``route``), else the plain version on ``g``'s own tensors, under the
    same degenerate-model rule; with ``replay``
    (``inference.replay.Replay``) the plain version runs through it."""
    if route("log_likelihood", g):
        return log_likelihood(g)
    if replay is None:
        return _plain_log_likelihood(g)[0]
    return replay(_plain_log_likelihood, g)[0]


def routed_fast_smoother_ll(g: LGSpec):
    """``fast_smoother_ll`` at a call site, routed as
    ``routed_log_likelihood``."""
    from . import kalman
    if route("fast_smoother_ll", g):
        return fast_smoother_ll(g)
    return kalman.fast_smoother_ll(g, degenerate=kalman.degenerate_h2rr)


# ---------------------------------------------------------------------------
# K1: whole Laplace mode iteration
# ---------------------------------------------------------------------------

class Staging(NamedTuple):
    """Where the ``laplace_solve`` kernel stages a pass."""
    rows: int          # rows of the batch a block takes, one thread each
    shared: bool       # in shared memory (else in a device-memory scratch)
    smem_bytes: int    # dynamic shared memory of a block (0: device memory)
    block_elems: int   # staged values of a block (shared) or of a row


def staging_options(n: int, m: int, itemsize: int):
    """``(shared, device)``: the two stagings of ``csrc/laplace_solve.cu``
    for series of length n, state dimension m and values of ``itemsize``
    bytes.  A row stages (3 + m + m^2) n pass values and two mode buffers.
    In shared memory (``block_elems`` values a block) the buffers have
    (n | 1) values and a block adds y and u, 2 n values; a block takes
    min(32, what fits in ``SMEM_LIMIT``) rows (None where not even one row
    fits).  In device memory (``block_elems`` values a row) the buffers
    have n values, blocks have 32 rows, and the scratch holds the batch
    rounded up to 32 rows."""
    row = (3 + m + m * m) * n + 2 * (n | 1)
    fixed = 2 * n
    most = THREADS_PER_ROW_BLOCK
    rows = min(most, (SMEM_LIMIT // itemsize - fixed) // row)
    shared = None
    if rows >= 1:
        elems = rows * row + fixed
        shared = Staging(rows, True, elems * itemsize, elems)
    return shared, Staging(most, False, 0, (5 + m + m * m) * n)


def shared_waves(st: Staging, B: int, sms: int) -> int:
    """Waves in which the blocks of the shared staging ``st`` run over B
    rows on ``sms`` multiprocessors."""
    per_sm = min(MAX_BLOCKS_PER_SM,
                 SMEM_PER_SM // (st.smem_bytes + SMEM_RESERVED))
    return -(-(-(-B // st.rows)) // (sms * per_sm))


def laplace_staging(n: int, m: int, itemsize: int, B: int,
                    sms: int) -> Staging:
    """The staging ``laplace_solve`` uses for B rows on a card of ``sms``
    multiprocessors (``staging_options``): shared memory while its blocks
    run in at most ``SHARED_WAVES`` waves, else device memory, where every
    row is resident at once.  Each wave of the shared staging costs a whole
    dependent chain of passes, so it loses once it needs a second."""
    shared, device = staging_options(n, m, itemsize)
    if shared is not None and shared_waves(shared, B, sms) <= SHARED_WAVES:
        return shared
    return device


def _align32(k: int) -> int:
    return -(-k // 32) * 32


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _laplace_args(name: str, spec: NGSpec, mode: torch.Tensor, B: int,
                  batch: Optional[int]):
    """Checks of the two Laplace kernels (``batch`` is ``spec.batch``);
    returns the ``SeriesArg`` fields of y, u, D and the mode, the
    ``SystemArg`` fields, and the leaves to keep alive until the launch."""
    _check_system(spec)
    if not SVM <= spec.distribution <= GAMMA:
        raise NotImplementedError(
            f"{name}: unsupported family {spec.distribution}")
    if batch not in (None, 1, B):
        raise ValueError(f"{name}: spec batch {batch} does not match "
                         f"the {B} rows of the mode")
    _check_tensors([("u", spec.u), ("D", spec.D), ("mode", mode),
                    ("Z", spec.Z), ("T", spec.T), ("R", spec.R),
                    ("a1", spec.a1), ("P1", spec.P1), ("C", spec.C),
                    ("phi", spec.phi)], spec.y)
    n = spec.n
    series = _strided(spec.y, B, n, "y", full=True) \
        + _strided(spec.u, B, n, "u", full=True) \
        + _strided(spec.D, B, n, "D") \
        + _strided(mode, B, n, "mode", full=True)
    sys_args, keep = _system_args(spec, B, with_phi=True)
    return series + sys_args, keep


def laplace_solve(spec: NGSpec, mode0: torch.Tensor, conv_tol: float,
                  max_iter: int, staging: Optional[Staging] = None):
    """Laplace mode iteration of every batch row, to per-row convergence.

    Returns ``(mode (B, n), prev (B, n), niter (B,) int32, diff (B,),
    ll (B,))``: the converged signal mode, the mode the last pass linearised
    at, the passes used, the last mean-squared change and the Kalman
    log-likelihood of the last pass's approximating model.  On the card the
    five are views of one allocation, and a call is one launch, staged as
    ``laplace_staging`` chooses unless ``staging`` says otherwise (the kernel
    refuses a geometry that does not match n and m).  While spans are on,
    the kernel adds the sum of ``niter`` to the open fit's pass counter
    (``profiling.passes_counter``); otherwise it gets no counter."""
    _univariate("laplace_solve", spec)
    if not spec.y.is_cuda:
        from ..inference.approx import laplace_solve_plain
        return laplace_solve_plain(spec, mode0, conv_tol, max_iter)
    batch = spec.batch
    B, n, m = batch or 1, spec.n, spec.m
    dt, dev = spec.y.dtype, spec.y.device
    args, keep = _laplace_args("laplace_solve", spec, mode0, B, batch)
    passes = profiling.passes_counter(dev)
    st = staging or laplace_staging(n, m, spec.y.element_size(), B,
                                    _sm_count(dev.index))
    Bn = B * n
    nout = 2 * Bn + 3 * B
    # device-memory staging: from a line of 32 values on, 32-row aligned
    size = nout if st.shared \
        else _align32(nout) + _align32(B) * st.block_elems
    buf = torch.empty((size,), dtype=dt, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        code = _call(lib.bssm_laplace_solve, _SOLVE_ARGS,
                     int(dt == torch.float64), m,
                     int(spec.distribution), B, n, *args, float(conv_tol),
                     int(max_iter), buf.data_ptr(), st.rows, int(st.shared),
                     st.smem_bytes, st.block_elems,
                     0 if passes is None else passes.data_ptr(),
                     _stream(dev))
    _check_launch(lib, code, "laplace_solve")
    LAUNCHES["laplace_solve"] += 1
    return (buf[:Bn].view(B, n), buf[Bn:2 * Bn].view(B, n),
            buf[2 * Bn + 2 * B:nout].view(torch.int32)[:B],
            buf[2 * Bn + B:2 * Bn + 2 * B], buf[2 * Bn:2 * Bn + B])


# ---------------------------------------------------------------------------
# K8: one pass of the Laplace iteration
# ---------------------------------------------------------------------------

def laplace_step(spec: NGSpec, mode: torch.Tensor,
                 staging: Optional[FsGeometry] = None):
    """One pass of the Laplace iteration at ``mode (B, n)`` for every batch
    row: ``(new_mode (B, n), ll (B,), diff (B,))``, the new signal mode, the
    Kalman log-likelihood of the approximating model at the pseudo-
    observations of ``mode``, and the mean-squared change of the mode.  The
    spec may be unbatched (one model, B rows of modes) or have B rows.  On
    the card the three are views of one allocation and a call is one
    launch, laid out as ``fs_geometry(..., step=True)`` chooses unless
    ``staging`` says otherwise (every layout gives the same bits)."""
    _univariate("laplace_step", spec)
    if not spec.y.is_cuda:
        from ..inference.approx import _laplace_step
        return _laplace_step(spec, mode)
    B, n, m = with_batch(mode, 1).shape[0], spec.n, spec.m
    dt, dev = spec.y.dtype, spec.y.device
    args, keep = _laplace_args("laplace_step", spec, mode, B, spec.batch)
    geo = staging or fs_geometry(n, m, spec.y.element_size(), B,
                                 _sm_count(dev.index), step=True)
    Bn = B * n
    out = torch.empty((Bn + 2 * B,), dtype=dt, device=dev)
    size = fs_scratch_elems(geo, B, n, m)
    scratch = torch.empty((size,), dtype=dt, device=dev) if size else None
    lib = _load()
    code = _launch(lib.bssm_laplace_step, _STEP_ARGS, dev,
                   int(dt == torch.float64), m, int(spec.distribution), B, n,
                   *args, out.data_ptr(),
                   0 if scratch is None else scratch.data_ptr(), geo.rows,
                   geo.threads, geo.chunk, geo.smem_bytes)
    _check_launch(lib, code, "laplace_step")
    LAUNCHES["laplace_step"] += 1
    return out[:Bn].view(B, n), out[Bn:Bn + B], out[Bn + B:]


# ---------------------------------------------------------------------------
# K2: Kalman filter + backward (FFBS) proposal factors
# ---------------------------------------------------------------------------

THREADS_RTS = 128          # threads of a rts_factors block
RTS_ROWS_SHARED = 8        # rows of a block, staging in shared memory
RTS_ROWS_DEVICE = 32       # rows of a block, staging in device memory
RTS_BLOCKS_PER_SM = 8      # the most shared-staging blocks an SM holds
# the most waves of shared-staging blocks for which shared memory is chosen
# over device memory (chip_smoke.py's rts staging sweep, PERF.md)
RTS_SHARED_WAVES = 3.5


def rts_step_elems(m: int) -> int:
    """Values ``csrc/rts_factors.cu`` stages a step: att (m) and the upper
    triangle of Ptt (m (m + 1) / 2)."""
    return m + m * (m + 1) // 2


def rts_row_elems(n: int, m: int) -> int:
    """Values the kernel stages for one row in shared memory: n steps, made
    odd."""
    return (rts_step_elems(m) * n) | 1


def rts_scratch_elems(B: int, n: int, m: int) -> int:
    """Values of the kernel's device-memory staging: n steps a row for B
    rows rounded up to whole blocks of ``RTS_ROWS_DEVICE``."""
    return -(-B // RTS_ROWS_DEVICE) * RTS_ROWS_DEVICE * rts_step_elems(m) * n


def rts_sys_elems(m: int) -> int:
    """Values of one row's T, R R' and C in the kernel's shared memory."""
    return 2 * m * m + m


def rts_layout(B: int, n: int, m: int) -> tuple:
    """``(Lb offset, Ab offset, length)`` in values of the one buffer that
    holds the kernel's three outputs: ahat from 0, Lb from the first line
    of 32 values after it, Ab right behind Lb."""
    k = B * (n + 1)
    lb = -(-k * m // 32) * 32
    return lb, lb + k * m * m, lb + 2 * k * m * m


class RtsGeometry(NamedTuple):
    """How ``csrc/rts_factors.cu`` lays a launch out."""
    rows: int          # rows of the batch a block takes
    shared: bool       # staging in shared memory (else a device scratch)
    smem_bytes: int    # dynamic shared memory of a block


def rts_shared_rows(n: int, m: int, itemsize: int, sms: int) -> int:
    """Rows that one wave of ``rts_factors`` blocks staged in shared memory
    (``RTS_ROWS_SHARED`` rows each, as many an SM as its shared memory
    holds, at most ``RTS_BLOCKS_PER_SM``) takes on ``sms`` multiprocessors;
    0 where such a block does not fit in ``SMEM_LIMIT``."""
    rows = RTS_ROWS_SHARED
    smem = rows * (rts_sys_elems(m) + rts_row_elems(n, m)) * itemsize
    if smem > SMEM_LIMIT:
        return 0
    return rows * sms * min(RTS_BLOCKS_PER_SM,
                            SMEM_PER_SM // (smem + SMEM_RESERVED))


@functools.lru_cache(maxsize=None)
def rts_geometry(n: int, m: int, itemsize: int, B: int,
                 sms: int) -> RtsGeometry:
    """The launch of ``rts_factors`` for B rows on a card of ``sms``
    multiprocessors: ``RTS_ROWS_SHARED`` rows a block staged in shared
    memory while those blocks run in at most ``RTS_SHARED_WAVES`` waves
    (``rts_shared_rows``: each further wave costs a whole forward chain),
    else ``RTS_ROWS_DEVICE`` rows a block staged in a device scratch,
    every row resident at once.  Shared memory also holds each row's T,
    R R' and C in both.  Cached: a chain asks for the same launch at every
    iteration."""
    if B <= RTS_SHARED_WAVES * rts_shared_rows(n, m, itemsize, sms):
        rows = RTS_ROWS_SHARED
        row = rts_sys_elems(m) + rts_row_elems(n, m)
        return RtsGeometry(rows, True, rows * row * itemsize)
    rows = RTS_ROWS_DEVICE
    return RtsGeometry(rows, False, rows * rts_sys_elems(m) * itemsize)


def rts_factors(g: LGSpec):
    """``(ahat (B, n+1, m), Lb (B, n+1, m, m), Ab (B, n+1, m, m))`` of the
    linear-Gaussian model ``g``; see ``ops/kalman.smoother_bwd_factors``.
    On the card the three are views of one allocation, and a call is one
    launch laid out as ``rts_geometry`` chooses."""
    _univariate("rts_factors", g)
    if not g.y.is_cuda:
        from .kalman import smoother_bwd_factors
        return smoother_bwd_factors(g)
    _check_system(g)
    y = g.y
    B, n, m = _batch(g), y.shape[-1], g.a1.shape[-1]
    dt, dev = y.dtype, y.device
    _check_tensors([("H", g.H), ("D", g.D)], y)
    series = _strided(y, B, n, "y", full=True) \
        + _strided(g.H, B, n, "H") + _strided(g.D, B, n, "D")
    sys_args, keep = _system_args(g, B, with_phi=False, ref=y)
    item = y.element_size()
    geo = rts_geometry(n, m, item, B, _sm_count(dev.index))
    lb, ab, total = rts_layout(B, n, m)
    out = torch.empty((total,), dtype=dt, device=dev)
    scratch = None if geo.shared else torch.empty(
        (rts_scratch_elems(B, n, m),), dtype=dt, device=dev)
    lib = _load()
    code = _launch(lib.bssm_rts_factors, _RTS_ARGS, dev,
                   int(dt == torch.float64), m, B, n, *series, *sys_args,
                   out.data_ptr(),
                   0 if scratch is None else scratch.data_ptr(), geo.rows,
                   THREADS_RTS, int(geo.shared), geo.smem_bytes)
    _check_launch(lib, code, "rts_factors")
    LAUNCHES["rts_factors"] += 1
    n1 = n + 1
    return (out.as_strided((B, n1, m), (n1 * m, m, 1)),
            out.as_strided((B, n1, m, m), (n1 * m * m, m * m, m, 1), lb),
            out.as_strided((B, n1, m, m), (n1 * m * m, m * m, m, 1), ab))


# ---------------------------------------------------------------------------
# K3: psi-APF log-weight, N <= 32
# ---------------------------------------------------------------------------

def psi_segment(N: int) -> tuple:
    """``(w, rows a warp)`` of the ``psi_logw`` kernel for N particles: a
    row takes w lanes, the least power of two >= N, so a warp serves
    32 / w rows."""
    w = 1
    while w < N:
        w *= 2
    return w, 32 // w


def psi_logw(spec: NGSpec, al, ahat: torch.Tensor, Lb: torch.Tensor,
             Ab: torch.Tensor, eps: torch.Tensor,
             us: torch.Tensor) -> torch.Tensor:
    """psi-APF log-weight ``(B,)`` of every batch row from the proposal
    factors and injected randomness ``eps (B, n+1, N, m)``, ``us (B, n, N)``.
    ``al`` is the row's ``ApproxLoglik`` (mode, ytilde, Htilde, scales)."""
    _univariate("psi_logw", spec)
    if not spec.y.is_cuda:
        from ..inference.particle import psi_logw_scan
        return psi_logw_scan(spec, al, eps, us, factors=(ahat, Lb, Ab))
    _check_system(spec)
    if not SVM <= spec.distribution <= GAMMA:
        raise NotImplementedError(
            f"psi_logw: unsupported family {spec.distribution}")
    y = spec.y
    B, n, m = eps.shape[0], y.shape[-1], spec.a1.shape[-1]
    N = eps.shape[2]
    if N > MAX_N_PSI:
        raise NotImplementedError(
            f"psi_logw handles N <= {MAX_N_PSI} particles, got {N}")
    # every tensor the kernel reads is checked against B below
    dt, dev = y.dtype, y.device
    yt, Ht, sc = al.approx.ytilde, al.approx.Htilde, al.scales
    _check_tensors([("u", spec.u), ("D", spec.D)], y)
    dense = [_dense(x, shape, name, y) for name, x, shape in (
        ("ytilde", yt, (B, n)), ("Htilde", Ht, (B, n)),
        ("scales", sc, (B, n)), ("ahat", ahat, (B, n + 1, m)),
        ("Lb", Lb, (B, n + 1, m, m)), ("Ab", Ab, (B, n + 1, m, m)),
        ("eps", eps, (B, n + 1, N, m)), ("us", us, (B, n, N)))]
    series = _strided(y, B, n, "y", full=True) \
        + _strided(spec.u, B, n, "u", full=True) + _strided(spec.D, B, n, "D")
    leaf_args, keep = _leaf_args(spec, B, ("Z", "phi"), ref=y)
    logw = torch.empty((B,), dtype=dt, device=dev)
    lib = _load()
    code = _launch(lib.bssm_psi_logw, _PSI_ARGS, dev,
                   int(dt == torch.float64), m, int(spec.distribution), N, B,
                   n, *series, *leaf_args, *[x.data_ptr() for x in dense],
                   logw.data_ptr(), THREADS_PSI_BLOCK)
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
                      dtype, row0: int = 0):
    """Plain version of ``philox_fill``: the same counter layout (particle,
    step, row, which) in tensor code, row ``b`` counted as ``row0 + b``.
    Words 0 and 1 of the call with which = 0 feed normals 0 and 1.  For
    m <= 2 its word 2 feeds the resampling uniform; for m > 2 words 2 and 3
    feed normals 2 and 3 and the uniform is word 0 of a second call,
    which = 1.  Beyond the kernels' m <= 4 (the plain routes of larger
    models), normals 4j..4j+3 come from the call with which = j + 1 in the
    same way."""
    dev = key.device
    k = (key[0] & 0xFFFFFFFF, key[1] & 0xFFFFFFFF)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)  # noqa: E731
    row = ((ar(B) + int(row0)) & 0xFFFFFFFF)[:, None, None]
    step, part = ar(steps)[None, :, None], ar(N)[None, None, :]
    zero = torch.zeros((B, steps, N), dtype=torch.int64, device=dev)
    ctr = [part + zero, step + zero, row + zero]
    call = lambda which: philox4x32_10(ctr + [zero + which], k)  # noqa
    groups = [call(0)] + [call(j + 1) for j in range(1, (m + 3) // 4)]
    zs = []
    for j in range((m + 1) // 2):
        w = groups[j // 2]
        rad = torch.sqrt(-2.0 * torch.log(_u01(w[2 * (j % 2)], dtype)))
        ang = 2.0 * torch.pi * _u01(w[2 * (j % 2) + 1], dtype)
        zs += [rad * torch.cos(ang), rad * torch.sin(ang)]
    eps = torch.stack(zs[:m], dim=-1).contiguous()
    wu = groups[0][2] if m <= 2 else call(1)[0]
    us = _u01(wu, dtype)[:, 1:].contiguous()
    return eps, us


def philox_fill(key: torch.Tensor, B: int, steps: int, N: int, m: int,
                dtype, row0: int = 0):
    """``(eps (B, steps, N, m), us (B, steps - 1, N))``: the standard
    normals and the resampling uniforms that the Philox mode of
    ``psi_big_logw`` / ``bsf_big_logw`` consumes for ``key`` and ``row0``
    (``us[:, s-1]`` belongs to generation step ``s``; row ``b`` is drawn as
    row ``row0 + b`` of a larger batch)."""
    if int(row0) < 0:
        raise ValueError("philox_fill: row0 must be >= 0")
    if not key.is_cuda:
        return philox_fill_plain(key, B, steps, N, m, dtype, row0)
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
            int(dtype == torch.float64), m, B, steps - 1, N, int(row0),
            key.data_ptr(), eps.data_ptr(), us.data_ptr(), _stream(dev))
    _check_launch(lib, code, "philox_fill")
    LAUNCHES["philox_fill"] += 1
    return eps, us


# ---------------------------------------------------------------------------
# K4 / K5: the large-ensemble particle kernel, psi mode and bootstrap mode
# ---------------------------------------------------------------------------

class BigGeometry(NamedTuple):
    """How ``csrc/particle_big.cu`` lays a launch out."""
    threads_per_row: int   # 32 or 64: one or two warps a row
    rows_per_block: int    # several rows only where a row is one warp
    pmax: int              # register slots of a thread: its most particles
    smem_bytes: int        # dynamic shared memory of a block


BIG_CHUNK = 16             # steps of row input a shared chunk holds
BIG_MAX_WARPS = 2          # warps a row may take
BIG_MAX_THREADS = 128      # threads a block may have
SMEM_DEFAULT = 48 * 1024   # dynamic shared memory without an opt-in


def big_pmax_choices(itemsize: int, m: int) -> tuple:
    """The slot counts the kernel is instantiated for (``big_all_p`` of
    ``csrc/particle_big.cuh``): 2 and 8, and 7 for float32 at m <= 2, the
    paths' shapes (N = 200 on one warp)."""
    return (2, 7, 8) if itemsize == 4 and m <= 2 else (2, 8)


def big_row_elems(N: int, m: int, bsf: bool) -> int:
    """Shared values of one row of the large-ensemble kernel (the kernel's
    ``big_row_elems``): two chunks of ``BIG_CHUNK`` steps of row input (psi:
    m + 2 m^2 + 6 scalars a step, bsf: 3), the ensemble (m N), the
    cumulative weights (N) and the reduction stage, rounded up to even."""
    row = 3 if bsf else m + 2 * m * m + 6
    e = 2 * BIG_CHUNK * row + m * N + N + 4 * BIG_MAX_WARPS
    return (e + 1) & ~1


@functools.lru_cache(maxsize=None)
def big_geometry(N: int, m: int, itemsize: int, bsf: bool) -> BigGeometry:
    """The launch of ``N`` particles: one warp a row up to N = 256 (no block
    barrier at all), two above; a thread's slots are the fewest instantiated
    (``big_pmax_choices``) that hold ceil(N / threads) particles; one-warp
    rows share blocks of up to four, as many as fit in ``SMEM_DEFAULT``.
    Cached: a chain asks for the same launch at every iteration."""
    w = 1 if N <= 256 else 2
    threads = 32 * w
    per = -(-N // threads)
    pmax = next((p for p in big_pmax_choices(itemsize, m) if p >= per), None)
    if pmax is None:
        raise ValueError(f"{N} particles need more than {w} warps a row")
    row_bytes = big_row_elems(N, m, bsf) * itemsize
    rows = 1 if w > 1 else max(1, min(BIG_MAX_THREADS // 32,
                                      SMEM_DEFAULT // row_bytes))
    return BigGeometry(threads, rows, pmax, rows * row_bytes)


def _randomness(name, B, steps, m, dev, eps, us, seed, nsim, anc, row0):
    """Checks the randomness arguments of the large-ensemble wrappers.
    Returns ``(N, eps, us, key, anc)`` with either the stream tensors (and
    the injected ancestors, if any) or the key set.  ``steps`` counts the
    initial draw."""
    if (eps is None) != (us is None) or (eps is None) == (seed is None):
        raise ValueError(f"{name}: give either eps and us, or seed")
    if int(row0) < 0 or (int(row0) and seed is None):
        raise ValueError(f"{name}: row0 >= 0, and only with a Philox seed")
    if anc is not None and eps is None:
        raise ValueError(f"{name}: injected ancestors need eps and us")
    if eps is not None:
        N = eps.shape[2]
        eps = _dense(eps, (B, steps, N, m), "eps")
        us = _dense(us, (B, steps - 1, N), "us")
        key = None
        if anc is not None:
            anc = _dense(anc, (B, steps - 1, N), "anc")
            if anc.dtype != torch.int32 or anc.device != eps.device:
                raise TypeError(f"{name}: anc must be int32 beside eps")
    else:
        if nsim is None:
            raise ValueError(f"{name}: seed needs nsim, the particle count")
        N, key = int(nsim), _check_key(seed, dev)
    if not 2 <= N <= MAX_N_BIG:
        raise NotImplementedError(
            f"{name} handles 2 <= N <= {MAX_N_BIG} particles, got {N}")
    return N, eps, us, key, anc


def _launch_big(name, spec, bsf, B, N, S, kk, psi_t, eps, us, anc, key,
                row0):
    """Shared launch of the two modes; ``psi_t`` = (ytilde, Htilde, scales,
    ahat, Lb, Ab) or None; ``row0`` the first row's place in the batch that
    the Philox counters count.  The bootstrap mode hands over a1, chol(P1),
    C, T and R as leaves where the spec holds them (``_bootstrap_leaves``)."""
    m = spec.m
    dt, dev = spec.y.dtype, spec.y.device
    n = spec.n
    series = _strided(spec.y, B, n, "y", full=True) \
        + _strided(spec.u, B, n, "u", full=True) + _strided(spec.D, B, n, "D")
    if bsf:
        leaf_args, keep = _bootstrap_leaves(spec, B)
        k = spec.k
    else:
        leaf_args, keep = _leaf_args(spec, B, ("Z", "phi"))
        leaf_args, k = leaf_args + [0] * 10, 0
    geo = big_geometry(N, m, spec.y.element_size(), bsf)
    out = torch.empty((B,), dtype=dt, device=dev)
    ptr = lambda x: 0 if x is None else x.data_ptr()        # noqa: E731
    psi_ptrs = [0] * 6 if psi_t is None else [x.data_ptr() for x in psi_t]
    lib = _load()
    with torch.cuda.device(dev):
        code = _call(lib.bssm_particle_big, _BIG_ARGS,
                     int(dt == torch.float64), m, int(spec.distribution),
                     int(bsf), int(key is not None), N, B, S, int(kk),
                     int(row0), geo.threads_per_row, geo.rows_per_block,
                     geo.pmax,
                     *psi_ptrs, *series, *leaf_args, k, ptr(eps),
                     ptr(us), ptr(anc), ptr(key), out.data_ptr(),
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
                 nsim: Optional[int] = None, anc=None,
                 row0: int = 0) -> torch.Tensor:
    """psi-APF log-weight ``(B,)`` of every batch row with 2 <= N <= 512
    particles, resampling at every ``kk``-th step.  Randomness: either
    injected ``eps (B, n+1, N, m)`` and ``us (B, n, N)``, or ``seed``, a
    Philox key (``philox_key``), together with ``nsim`` = N; row ``b`` then
    draws as row ``row0 + b`` of its batch (``core.rows``).  ``anc
    (B, n, N)`` int32, with the injected tensors only, gives the ancestors
    of every resampling step in place of the search (a check: the plain
    version takes the same tensor)."""
    _univariate("psi_big_logw", spec)
    B, n, m = al.approx.mode.shape[0], spec.n, spec.m
    N, eps, us, key, anc = _randomness("psi_big_logw", B, n + 1, m,
                                       spec.y.device, eps, us, seed, nsim,
                                       anc, row0)
    if not spec.y.is_cuda:
        from ..inference.particle import psi_logw_scan
        if eps is None:
            eps, us = philox_fill_plain(key, B, n + 1, N, m, spec.y.dtype,
                                        row0)
        return psi_logw_scan(spec, al, eps, us, factors=(ahat, Lb, Ab),
                             resample_every=kk, anc=anc)
    _check_big("psi_big_logw", spec, kk)
    if spec.batch not in (None, 1, B):
        raise ValueError("spec batch does not match the approximation")
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
    return _launch_big("psi_big_logw", spec, False, B, N, n, kk, psi_t, eps,
                       us, anc, key, row0)


def pack_bootstrap_system(spec: NGSpec, B: int) -> torch.Tensor:
    """``(B, 2m + 3m^2)`` rows [a1, chol(P1), C, R, T] of the time-invariant
    system, R zero-padded to m columns (more columns than states are not
    served): the system of the plain version ``bsf_logw_scan``.  The kernel
    reads the leaves where they lie (``_bootstrap_leaves``)."""
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


# the last P1 whose Cholesky factor the bootstrap mode took, its version and
# the factor: a model's P1 is one tensor from build to build, so a chain
# factors it once
_P1_CHOL: list = [None, -1, None]


def _p1_chol(P1: torch.Tensor) -> torch.Tensor:
    """``psd_chol(P1)``, taken once per distinct P1 (the same tensor at the
    same version gives the factor taken before): one matrix when P1 has no
    batch axis."""
    from .chol import psd_chol
    if _P1_CHOL[0] is not P1 or _P1_CHOL[1] != P1._version:
        _P1_CHOL[:] = [P1, P1._version, psd_chol(P1)]
    return _P1_CHOL[2]


def _bootstrap_leaves(spec: NGSpec, B: int):
    """``LeafArg`` fields of Z, phi, a1, L1 = chol(P1), C, T and R (its own
    k columns) for the bootstrap mode, and the tensors to keep alive."""
    flat, keep = _leaf_args(spec, B, ("Z", "phi", "a1", "C", "T", "R"))
    L1 = _p1_chol(spec.P1)
    b = L1.shape[0] if L1.dim() == 3 else 1
    if b not in (1, B):
        raise ValueError(f"P1: batch {b} does not match {B}")
    l1 = [L1.data_ptr(), L1.stride(0) if b > 1 else 0]
    return flat[:6] + l1 + flat[6:], (keep, L1)


def bsf_big_logw(spec: NGSpec, kk: int, *, eps=None, us=None, seed=None,
                 nsim: Optional[int] = None, anc=None,
                 row0: int = 0) -> torch.Tensor:
    """Bootstrap-filter log-likelihood ``(B,)`` less the observation
    constants, 2 <= N <= 512 particles, resampling at every ``kk``-th step.
    Randomness: either injected ``eps (B, n, N, m)`` and ``us (B, n-1, N)``
    (and, as a check, ``anc (B, n-1, N)``), or ``seed`` (a Philox key) with
    ``nsim``; B is then the batch size of ``spec``, and row ``b`` draws as
    row ``row0 + b``.  R may have fewer columns than states."""
    _univariate("bsf_big_logw", spec)
    n, m = spec.n, spec.m
    B = eps.shape[0] if eps is not None else _batch(spec)
    N, eps, us, key, anc = _randomness("bsf_big_logw", B, n, m,
                                       spec.y.device, eps, us, seed, nsim,
                                       anc, row0)
    if not spec.y.is_cuda:
        from ..inference.particle import bsf_logw_scan
        if eps is None:
            eps, us = philox_fill_plain(key, B, n, N, m, spec.y.dtype, row0)
        return bsf_logw_scan(spec, eps, us, resample_every=kk, anc=anc)
    _check_big("bsf_big_logw", spec, kk)
    if spec.k > m:
        raise NotImplementedError(
            f"bsf_big_logw: R has {spec.k} columns, more than the {m} states")
    if spec.batch not in (None, 1, B):
        raise ValueError("spec batch does not match eps")
    named = [("u", spec.u), ("D", spec.D), ("Z", spec.Z), ("phi", spec.phi),
             ("T", spec.T), ("R", spec.R), ("a1", spec.a1), ("P1", spec.P1),
             ("C", spec.C)]
    if eps is not None:
        named += [("eps", eps), ("us", us)]
    _check_tensors(named, spec.y)
    return _launch_big("bsf_big_logw", spec, True, B, N, n - 1, kk, None, eps,
                       us, anc, key, row0)
