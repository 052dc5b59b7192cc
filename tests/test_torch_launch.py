"""The launch geometry and argument description of the kernels, on the
CPU: what ``ops/cuda_kalman.py`` hands them, checked without a card.

- ``staging_options`` / ``laplace_staging``: rows a block and where a
  Laplace pass is staged, on both sides of the 227 KB shared-memory limit
  and of the wave count up to which shared memory is chosen, m = 1..4,
  float32 and float64; ``kalman_tile``: the chunks of the D tile;
  ``rts_geometry``: where ``rts_factors`` stages (shared memory up to its
  footprint and wave limits, device memory beyond) and ``rts_layout``, its
  one output buffer; ``psi_segment``: the lanes a row of ``psi_logw``
  takes, on both sides of each power of two.
- ``system_leaves`` and ``_strided``: each leaf as (pointer, batch stride
  [, time stride]), read back with ``torch.as_strided`` the way the kernels
  read it, reproduces the packed system the first design launched with
  (``_packed_system``, its copy here) and the broadcast series, for shared,
  expanded, per-row and non-contiguous leaves.
- The degenerate-model rule as the kernels apply it (H^2 summed over the
  steps as the filter reads them, plus sum |R R'| from the R they read), in
  plain Python, against ``ops/kalman.degenerate_h2rr`` and against the -inf
  rows of the JAX package's log-likelihood kernel in interpret mode.

Read-back comparisons are exact up to the rounding of one batched matrix
product (R R'): rtol 1e-12 in float64, 1e-6 in float32.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core.spec import LGSpec as JLGSpec
from bssm_tpu.ops.pallas_kalman import fused_log_likelihood_batched

import bssm_tpu_torch as bt
from bssm_tpu_torch.convert import lgspec_from_numpy
from bssm_tpu_torch.core.spec import NGSpec, with_batch
from bssm_tpu_torch.ops import cuda_kalman as ck
from bssm_tpu_torch.ops import kalman as tkalman

ITEM = {torch.float32: 4, torch.float64: 8}


# ---------------------------------------------------------------------------
# staging and tile geometry
# ---------------------------------------------------------------------------

def _row_bytes(n, m, item):
    """One row's staging in shared memory in the laplace_solve kernel: the
    pass values and two mode buffers of odd leading dimension."""
    return ((3 + m + m * m) * n + 2 * (n | 1)) * item


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_laplace_staging_on_both_sides_of_the_limit(m, dtype):
    item = ITEM[dtype]
    fixed = lambda n: 2 * n * item                        # noqa: E731
    # the longest series of which one row still fits
    n = 1
    while fixed(n + 1) + _row_bytes(n + 1, m, item) <= ck.SMEM_LIMIT:
        n += 1
    inside, _ = ck.staging_options(n, m, item)
    outside_shared, outside = ck.staging_options(n + 1, m, item)
    assert inside.shared and inside.rows == 1
    assert inside.smem_bytes == fixed(n) + _row_bytes(n, m, item) \
        <= ck.SMEM_LIMIT
    assert inside.block_elems * item == inside.smem_bytes
    assert outside_shared is None
    assert not outside.shared and outside.rows == ck.THREADS_PER_ROW_BLOCK
    assert outside.smem_bytes == 0
    assert outside.block_elems == (5 + m + m * m) * (n + 1)
    # one row in one wave: the wrapper stages in shared memory up to the
    # limit and in device memory beyond it
    assert ck.laplace_staging(n, m, item, 1, 132) == inside
    assert ck.laplace_staging(n + 1, m, item, 1, 132) == outside
    # below the limit: as many rows as fit, at most 32
    for k in (5, 40, 153, n // 2, n - 1):
        st, dev = ck.staging_options(k, m, item)
        rows = min(32, (ck.SMEM_LIMIT - fixed(k)) // _row_bytes(k, m, item))
        assert st.shared and st.rows == rows >= 1
        assert st.smem_bytes == fixed(k) + rows * _row_bytes(k, m, item)
        assert st.smem_bytes <= ck.SMEM_LIMIT
        if rows < 32:
            assert st.smem_bytes + _row_bytes(k, m, item) > ck.SMEM_LIMIT
        assert not dev.shared and dev.rows == 32
        assert dev.block_elems == (5 + m + m * m) * k


def _waves(st, B, sms):
    """Waves of the shared staging's blocks: as many blocks an SM as its
    228 KB hold, each with its 1 KB reserve."""
    blocks = -(-B // st.rows)
    per_sm = min(32, (228 * 1024) // (st.smem_bytes + 1024 + 128))
    return -(-blocks // (sms * per_sm))


@pytest.mark.parametrize("item", [4, 8])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_laplace_staging_picks_by_waves(m, item):
    """Shared memory while its blocks run in at most SHARED_WAVES waves,
    device memory beyond; the switch sits at the last B of the last allowed
    wave."""
    sms = 132
    shared, device = ck.staging_options(153, m, item)
    assert ck.shared_waves(shared, 1, sms) == 1
    per_sm = min(32, (228 * 1024) // (shared.smem_bytes + 1024 + 128))
    last = shared.rows * sms * per_sm * ck.SHARED_WAVES
    for B in (1, 1024, 4096, 16384, last - 1, last, last + 1, 4 * last):
        w = ck.shared_waves(shared, B, sms)
        assert w == _waves(shared, B, sms)
        pick = ck.laplace_staging(153, m, item, B, sms)
        assert pick == (shared if w <= ck.SHARED_WAVES else device)
    assert ck.laplace_staging(153, m, item, last, sms) == shared
    assert ck.laplace_staging(153, m, item, last + 1, sms) == device
    # more multiprocessors hold more rows at once
    assert ck.shared_waves(shared, last + 1, 2 * sms) \
        <= ck.SHARED_WAVES


def test_laplace_staging_of_the_main_path():
    """m = 2, n = 153: 32 rows a block, one warp, in 227 KB in float32; the
    limits the kernel's notes quote; the main path's widths on an H100's
    132 SMs."""
    shared, _ = ck.staging_options(153, 2, 4)
    assert shared == ck.Staging(32, True, 216648, 54162)
    assert ck.staging_options(153, 2, 8)[0].rows == 17
    assert ck.staging_options(153, 4, 8)[0].rows == 7
    assert ck.staging_options(4467, 2, 4)[0] is not None
    assert ck.staging_options(4468, 2, 4)[0] is None
    assert ck.staging_options(1075, 4, 8)[0] is not None
    assert ck.staging_options(1076, 4, 8)[0] is None
    for B in (1024, 4096):                 # the chains: one wave
        assert ck.laplace_staging(153, 2, 4, B, 132) == shared


def _rts_block_bytes(n, m, item, rows):
    """Shared memory of a rts_factors block staging in shared memory: each
    row's T, R R' and C, and its staged values, att and the upper triangle
    of Ptt at n steps, made odd."""
    return rows * (2 * m * m + m + ((m + m * (m + 1) // 2) * n | 1)) * item


@pytest.mark.parametrize("item", [4, 8])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_rts_geometry_on_both_sides_of_each_limit(m, item):
    """rts_factors stages 8 rows a block in shared memory while they fit in
    227 KB and run in at most RTS_SHARED_WAVES waves (as many blocks an SM
    as its 228 KB hold, each with its 1 KB reserve, at most 8), and 32 rows
    a block in a device scratch beyond either limit (then only the systems
    are in shared memory)."""
    rows = ck.RTS_ROWS_SHARED
    device = ck.RtsGeometry(ck.RTS_ROWS_DEVICE, False,
                            ck.RTS_ROWS_DEVICE * (2 * m * m + m) * item)
    # the footprint limit, at one row
    n = 1
    while _rts_block_bytes(n + 1, m, item, rows) <= ck.SMEM_LIMIT:
        n += 1
    inside = ck.rts_geometry(n, m, item, 1, 132)
    assert inside == ck.RtsGeometry(rows, True,
                                    _rts_block_bytes(n, m, item, rows))
    assert inside.smem_bytes <= ck.SMEM_LIMIT
    assert ck.rts_geometry(n + 1, m, item, 1, 132) == device
    assert ck.rts_shared_rows(n + 1, m, item, 132) == 0
    # the wave limit, at the main path's n where it fits
    k = min(153, n)
    geo = ck.rts_geometry(k, m, item, 1, 132)
    assert geo.shared and geo.smem_bytes == _rts_block_bytes(k, m, item,
                                                             rows)
    per_sm = min(8, (228 * 1024) // (geo.smem_bytes + 1024 + 128))
    assert ck.rts_shared_rows(k, m, item, 132) == rows * 132 * per_sm
    last = int(rows * 132 * per_sm * ck.RTS_SHARED_WAVES)
    assert ck.rts_geometry(k, m, item, last, 132) == geo
    assert ck.rts_geometry(k, m, item, last + 1, 132) == device
    assert ck.rts_geometry(k, m, item, last + 1, 264).shared


def test_rts_geometry_of_the_main_path():
    """m = 2, n = 153, float32: 8 rows a block in 24800 bytes, eight
    blocks an SM (the kernel's launch bound), 8448 rows a wave on 132 SMs,
    shared memory up to 3.5 waves: every batch of the paths (1024 rows,
    the 16384-row chunks of phase 2) in shared memory, device memory from
    29569 rows; the footprint limit at n = 1449 (float32, m = 2), n = 723
    (float64, m = 2) and n = 256 (float64, m = 4).  The kernel's thread limit and launch bound
    are the wrapper's."""
    import re
    shared = ck.RtsGeometry(8, True, 24800)
    for B in (1, 1024, 4096, 16384, 29568):
        assert ck.rts_geometry(153, 2, 4, B, 132) == shared
    assert ck.rts_geometry(153, 2, 4, 29569, 132) == ck.RtsGeometry(
        32, False, 1280)
    assert ck.rts_geometry(256, 4, 8, 64, 132).shared
    assert not ck.rts_geometry(257, 4, 8, 64, 132).shared
    assert ck.rts_geometry(1449, 2, 4, 64, 132).shared
    assert not ck.rts_geometry(1450, 2, 4, 64, 132).shared
    assert ck.rts_geometry(723, 2, 8, 64, 132).shared
    assert not ck.rts_geometry(724, 2, 8, 64, 132).shared
    src = (ck.CSRC / "rts_factors.cu").read_text()
    const = dict(re.findall(r"constexpr int (kRts\w+) = (\d+);", src))
    assert int(const["kRtsMaxThreads"]) == ck.THREADS_RTS
    assert int(const["kRtsMinBlocks"]) == ck.RTS_BLOCKS_PER_SM


@pytest.mark.parametrize("B,n,m", [(1, 4, 1), (3, 6, 3), (1024, 153, 2),
                                   (5, 10, 4), (7, 2, 2)])
def test_rts_layout_keeps_runs_aligned(B, n, m):
    """The one output buffer of rts_factors: ahat, then Lb from a line of
    32 values, then Ab right behind it; at even m (the runs of m^2 values
    the kernel stores 16 bytes at a time) every run of Lb and Ab starts on
    a multiple of m^2 values, so those stores stay aligned."""
    lb, ab, total = ck.rts_layout(B, n, m)
    k = B * (n + 1)
    assert lb % 32 == 0 and k * m <= lb < k * m + 32
    assert ab == lb + k * m * m and total == ab + k * m * m
    assert m % 2 or (lb % (m * m) == 0 and ab % (m * m) == 0)


@pytest.mark.parametrize("N,want", [(1, (1, 32)), (2, (2, 16)), (3, (4, 8)),
                                    (4, (4, 8)), (5, (8, 4)), (7, (8, 4)),
                                    (8, (8, 4)), (9, (16, 2)), (10, (16, 2)),
                                    (16, (16, 2)), (17, (32, 1)),
                                    (32, (32, 1))])
def test_psi_segment_on_both_sides_of_each_power_of_two(N, want):
    """psi_logw gives a row the least power of two >= N lanes, so a warp
    serves 32 / w rows; the C entry computes the same (psi_segment of
    csrc/psi_logw.cu, a doubling loop from 1) and a block of
    THREADS_PSI_BLOCK threads serves four warps' rows."""
    w, rows = ck.psi_segment(N)
    assert (w, rows) == want and w * rows == 32 and w >= N > w // 2
    src = (ck.CSRC / "psi_logw.cu").read_text()
    assert "int w = 1;\n  while (w < N) w <<= 1;" in src
    assert "a.threads / 32 * (32 / bssm::psi_segment((int)a.N))" in src
    assert ck.THREADS_PSI_BLOCK == 128


@pytest.mark.parametrize("item", [4, 8])
def test_kalman_tile(item):
    rows = ck.THREADS_PER_ROW_BLOCK
    n_whole = max(n for n in range(1, 2000)
                  if rows * (n | 1) * item <= ck.TILE_BYTES)
    assert n_whole == (383 if item == 4 else 191)
    for n in (1, 40, 153, n_whole):
        assert ck.kalman_tile(n, item) == (n, rows * (n | 1) * item)
    for n in (n_whole + 1, 600, 5000):
        chunk, smem = ck.kalman_tile(n, item)
        assert chunk % 2 == 1 and chunk < n
        assert smem == 2 * rows * chunk * item <= ck.TILE_BYTES
        assert 2 * rows * (chunk + 2) * item > ck.TILE_BYTES
    assert ck.kalman_tile(153, 4) == (153, 19584)


def _fs_bytes(rows, steps, m, item, step):
    """Shared memory of a fast_smoother_ll (``step``: laplace_step) block:
    each row's Z and T, its tile of 2m + 1 + m(m+1)/2 values a step made
    odd, and laplace_step's 32 partial sums a row."""
    tile = rows * (m + m * m + ((2 * m + 1 + m * (m + 1) // 2) * steps | 1))
    return (tile + (32 * rows if step else 0)) * item


def _fs_per_sm(geo):
    """Blocks of ``geo`` an SM holds: its 228 KB (each block with a 1 KB
    reserve), its 64 warps, at most 32 blocks."""
    return min(32, 64 // (geo.threads // 32),
               (228 * 1024) // (geo.smem_bytes + 1024 + 128))


@pytest.mark.parametrize("step", [False, True])
@pytest.mark.parametrize("item", [4, 8])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_fs_geometry_on_both_sides_of_each_limit(m, item, step):
    """fast_smoother_ll (and laplace_step, ``step``) keeps the whole series
    of 8 rows a block (one row for one model) in shared memory while it
    fits in 227 KB and its blocks run in at most FS_SHARED_WAVES
    (STEP_SHARED_WAVES) waves, and takes 32 rows a block with tiles and
    checkpoints beyond either limit; the tile holds 12 KB of steps."""
    sms, most = 132, ck.STEP_SHARED_WAVES if step else ck.FS_SHARED_WAVES
    geo = lambda n, B: ck.fs_geometry(n, m, item, B, sms, step)  # noqa: E731
    chunk = lambda n: max(1, min(n, 12 * 1024 // (            # noqa: E731
        32 * (2 * m + 1 + m * (m + 1) // 2) * item)))
    tiled = lambda n: ck.FsGeometry(32, 32, chunk(n), _fs_bytes(  # noqa
        32, chunk(n), m, item, step))
    for rows, B in ((8, 8), (1, 1)):
        # the footprint limit
        n = 1
        while _fs_bytes(rows, n + 1, m, item, step) <= ck.SMEM_LIMIT:
            n += 1
        assert geo(n, B) == ck.FsGeometry(rows, 128, n, _fs_bytes(
            rows, n, m, item, step))
        assert geo(n + 1, B) == tiled(n + 1)
        assert ck.fs_options(n + 1, m, item, step, rows)["shared"] is None
        assert ck.fs_scratch_elems(geo(n, B), B, n, m) == 0
    # the wave limit at the main path's n
    shared = geo(153, 8)
    assert shared.chunk == 153 and shared.rows == 8
    per_sm = _fs_per_sm(shared)
    last = 8 * int(most * sms * per_sm)
    assert ck.fs_waves(shared, last, sms) <= most \
        < ck.fs_waves(shared, last + 1, sms)
    assert geo(153, last) == shared
    assert geo(153, last + 1) == tiled(153)
    assert ck.fs_geometry(153, m, item, last + 1, 2 * sms, step) == shared


def test_fs_geometry_of_the_main_path():
    """m = 2, n = 153, float32 on 132 SMs: fast_smoother_ll's whole series
    in 39392 bytes for 8 rows (five blocks an SM, 2.5 waves: the 1024- and
    4096-row batches) and tiles of 12 steps in 13184 bytes with
    checkpoints at the 16384- and 65536-row chunks; laplace_step's one
    model a block of 128 threads, its 4096 and 16384 rows in shared
    memory (up to 4 waves).  The C side takes these geometries."""
    import re
    shared = ck.FsGeometry(8, 128, 153, 39392)
    tiled = ck.FsGeometry(32, 32, 12, 13184)
    for B, want in ((1024, shared), (4096, shared), (16384, tiled),
                    (65536, tiled)):
        assert ck.fs_geometry(153, 2, 4, B, 132) == want
    assert ck.fs_geometry(153, 2, 4, 1, 132) == ck.FsGeometry(
        1, 128, 153, 4924)
    assert ck.fs_scratch_elems(tiled, 65536, 153, 2) == 65536 * 5 * 12
    step = ck.FsGeometry(8, 128, 153, 40416)
    for B in (4096, 16384):
        assert ck.fs_geometry(153, 2, 4, B, 132, step=True) == step
    assert ck.fs_geometry(153, 2, 4, 1, 132, step=True) == ck.FsGeometry(
        1, 128, 153, 5052)
    assert ck.fs_geometry(153, 2, 4, 65536, 132, step=True).rows == 32
    kf = (ck.CSRC / "kalman_filter.cu").read_text()
    ls = (ck.CSRC / "laplace_solve.cu").read_text()
    assert int(re.search(r"kFsMaxThreads = (\d+);", kf)[1]) \
        >= ck.FS_THREADS
    assert int(re.search(r"kStepMaxThreads = (\d+);", ls)[1]) \
        >= ck.FS_THREADS

    def c_function(src, name):
        """The C function ``name`` (integer arithmetic only) as Python."""
        body = src[src.index(f"long long {name}("):]
        body = body[body.index("{") + 1:body.index("\n}")]
        lines = [ln.split("//")[0].strip().rstrip(";") for ln in
                 body.splitlines()]
        code = "\n".join(ln.replace("const long long ", "")
                         .replace("return ", "out = ").replace(" / ", " // ")
                         for ln in lines if ln)
        return lambda **kw: (exec(code, {}, kw), kw["out"])[1]

    fs_c = c_function(kf, "fs_block_elems")
    step_c = c_function(ls, "step_block_elems")
    for m in (1, 2, 3, 4):
        for rows, steps in ((1, 1), (8, 153), (32, 12), (7, 40)):
            assert fs_c(rows=rows, len=steps, m=m) \
                == ck.fs_block_elems(rows, steps, m)
            assert step_c(rows=rows, len=steps, m=m) \
                == ck.step_block_elems(rows, steps, m)


@pytest.mark.parametrize("B,n,m", [(1, 40, 1), (45, 30, 2), (64, 153, 3),
                                   (33, 7, 4)])
def test_fs_checkpoints_fill_the_scratch_once(B, n, m):
    """The checkpoints of a tiled launch, indexed as split_save indexes them
    (block b0's run of (tiles - 1) checkpoints, each field's rows side by
    side), cover ``fs_scratch_elems`` values each exactly once."""
    geo = ck.FsGeometry(32, 32, 4, 0)
    size = ck.fs_scratch_elems(geo, B, n, m)
    cf = m + m * (m + 1) // 2
    ntiles = -(-n // geo.chunk)
    seen = np.zeros(size, dtype=int)
    for b0 in range(0, B, geo.rows):
        base = b0 * cf * (ntiles - 1)
        for r in range(min(geo.rows, B - b0)):
            for c in range(ntiles - 1):
                for f in range(cf):
                    seen[base + c * cf * geo.rows + f * geo.rows + r] += 1
    full = -(-B // geo.rows) * geo.rows
    assert size == full * cf * (ntiles - 1)
    # rows of a partial last block leave their slots unused, no others
    assert (seen <= 1).all() and seen.sum() == B * cf * (ntiles - 1)


# ---------------------------------------------------------------------------
# the leaves as the kernels read them
# ---------------------------------------------------------------------------

def _model(kind, dtype):
    rng = np.random.default_rng(7)
    n = 30
    if kind == "bsm_ng":          # the main path's model at a short n
        y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0))
        return bt.bsm_ng(y.astype(float), sd_level=bt.halfnormal_prior(0.1, 1),
                         sd_slope=bt.halfnormal_prior(0.01, 0.1),
                         distribution="poisson", dtype=dtype, device="cpu")
    if kind == "bsm_ng_negbin_seasonal":   # R (3, 2), phi estimated
        y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0))
        return bt.bsm_ng(y.astype(float), sd_level=bt.halfnormal_prior(0.1, 1),
                         sd_seasonal=bt.halfnormal_prior(0.05, 1.0),
                         period=3, distribution="negative binomial",
                         phi=bt.gamma_prior(3.0, 2.0, 1.0),
                         xreg=rng.normal(0, .3, (n, 2)),
                         beta=bt.normal_prior(np.zeros(2), 0.0, 1.0),
                         dtype=dtype, device="cpu")
    if kind == "bsm_lg_airquality":
        aq = bt.airquality()
        return bt.bsm_lg(aq["Ozone"],
                         xreg=np.column_stack([aq["Wind"], aq["Temp"]]),
                         beta=bt.normal_prior(np.zeros(2), 0.0, 1.0),
                         sd_y=bt.gamma_prior(1.0, 2.0, 0.01),
                         sd_level=bt.gamma_prior(1.0, 2.0, 0.01),
                         sd_slope=bt.gamma_prior(1.0, 2.0, 0.01),
                         dtype=dtype, device="cpu")
    y = np.cumsum(rng.normal(0, 0.3, n)) * 0.3
    return bt.ar1_lg(y, rho=bt.uniform_prior(0.6, -0.999, 0.999),
                     sigma=bt.halfnormal_prior(0.3, 1.0),
                     mu=bt.normal_prior(0.2, 0.0, 2.0),
                     sd_y=bt.halfnormal_prior(0.4, 1.0),
                     xreg=rng.normal(size=(n, 1)),
                     beta=bt.normal_prior(np.zeros(1), 0.0, 1.0),
                     dtype=dtype, device="cpu")


def _replace(spec, **kw):
    return dataclasses.replace(spec, **kw) if isinstance(spec, NGSpec) \
        else spec._replace(**kw)


_CORE = {"Z": 2, "T": 3, "R": 3, "a1": 1, "P1": 2, "C": 2, "phi": 0}


def _layouts(spec, B):
    """The spec as the model built it; every leaf an expand view of
    stride 0 where it is shared; every leaf a per-row copy, T and P1 with
    a non-contiguous core."""
    names = list(_CORE) if isinstance(spec, NGSpec) else list(_CORE)[:-1]
    expand, per_row = {}, {}
    for f in names:
        x = getattr(spec, f)
        if x.dim() == _CORE[f]:
            x = x.unsqueeze(0)
        ex = x.expand(B, *x.shape[1:])
        expand[f] = ex
        pr = ex.contiguous()
        if f in ("T", "P1"):
            pr = pr.transpose(-1, -2).contiguous().transpose(-1, -2)
            assert spec.m == 1 or not pr.is_contiguous()
        per_row[f] = pr
    return {"as built": spec, "expanded": _replace(spec, **expand),
            "per row": _replace(spec, **per_row)}


def _packed_system(spec, B, with_phi):
    """The system as the first design packed it for the kernels: one
    ``(rows, B)`` tensor [Z (m), T (m^2), RR (m^2), a1 (m), P1 (m^2),
    C (m)] (+ [phi]), batch innermost."""
    R = with_batch(spec.R, 3)[:, 0]
    leaves = [with_batch(spec.Z, 2)[:, 0], with_batch(spec.T, 3)[:, 0],
              R @ R.transpose(-1, -2), with_batch(spec.a1, 1),
              with_batch(spec.P1, 2), with_batch(spec.C, 2)[:, 0]]
    if with_phi:
        leaves.append(with_batch(spec.phi, 0))
    rows = [x.reshape(x.shape[0], -1).expand(B, -1).T for x in leaves]
    return torch.cat(rows, dim=0).contiguous()


def _names(with_phi):
    return ck.SYSTEM + (("phi",) if with_phi else ())


def _read_back(spec, B, with_phi):
    """The (rows, B) system as the kernels read it: element i of row b at
    pointer + b * stride + i; R R' from the R read."""
    rows = []
    for name, x, bs in ck.system_leaves(spec, B, _names(with_phi)):
        core = list(x.shape[x.dim() - _CORE[name]:])
        if name in ("Z", "T", "R", "C"):
            core = core[1:]                        # the time axis of size 1
        k = int(np.prod(core)) if core else 1
        v = torch.as_strided(x, (B, k), (bs, 1), x.storage_offset())
        if name == "R":
            Rm = v.reshape(B, spec.m, spec.k)
            v = (Rm @ Rm.transpose(-1, -2)).reshape(B, -1)
        rows.append(v)
    return torch.cat(rows, dim=1).T


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["bsm_ng", "bsm_ng_negbin_seasonal",
                                  "bsm_lg_airquality", "ar1_lg"])
def test_leaves_read_back_reproduce_the_packed_system(kind, dtype):
    model = _model(kind, dtype)
    B = 5
    rng = np.random.default_rng(3)
    th = np.asarray(model.theta_init)[None] + 0.2 * rng.normal(
        size=(B, len(model.theta_init)))
    spec0 = model.build(torch.as_tensor(th, dtype=dtype))
    ng = isinstance(spec0, NGSpec)
    want = _packed_system(spec0, B, with_phi=ng)
    rtol = 1e-12 if dtype == torch.float64 else 1e-6
    for label, spec in _layouts(spec0, B).items():
        got = _read_back(spec, B, with_phi=ng)
        torch.testing.assert_close(got, want, rtol=rtol, atol=0,
                                   msg=f"{kind} {label}")
        leaves = {nm: (x, bs) for nm, x, bs in
                  ck.system_leaves(spec, B, _names(ng))}
        if label == "expanded":
            for nm, (x, bs) in leaves.items():
                x0 = getattr(spec0, nm)
                shared = x0.dim() == _CORE[nm] or x0.shape[0] == 1
                assert (bs == 0) == shared, nm
        if label == "per row":
            assert all(bs > 0 for _, bs in leaves.values())
        flat, _ = ck._system_args(spec, B, with_phi=ng)
        assert len(flat) == 15 and flat[-1] == spec.k
        # the series the kernels read: y, u / H, D
        n = spec.n
        names = ("y", "u", "D") if ng else ("y", "H", "D")
        for nm in names:
            x = getattr(spec, nm)
            p, bs, ts = ck._strided(x, B, n, nm)
            assert p == x.data_ptr()
            read = torch.as_strided(x, (B, n), (bs, ts), x.storage_offset())
            x2 = x if x.dim() == 2 else x[None]
            torch.testing.assert_close(read, x2.expand(B, n), rtol=0, atol=0,
                                       equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["bsm_ng", "bsm_ng_negbin_seasonal"])
def test_bootstrap_leaves_read_back_the_plain_system(kind, dtype):
    """The bootstrap mode's leaves (Z, phi, a1, L1 = chol(P1), C, T, R in the
    order of ``BigLaunch``), read as the kernel reads them, give the system
    of its plain version (``pack_bootstrap_system``: R zero-padded to m
    columns) exactly, on the three layouts; R is read by its own k
    columns, and chol(P1) is taken once per distinct P1."""
    model = _model(kind, dtype)
    B, m = 5, model.extra["m"]
    rng = np.random.default_rng(4)
    th = np.asarray(model.theta_init)[None] + 0.2 * rng.normal(
        size=(B, len(model.theta_init)))
    spec0 = model.build(torch.as_tensor(th, dtype=dtype))
    want = ck.pack_bootstrap_system(spec0, B)
    for label, spec in _layouts(spec0, B).items():
        flat, keep = ck._bootstrap_leaves(spec, B)
        assert len(flat) == 14
        leaves, L1 = keep              # what the pointers point into
        tensors = {nm: x for nm, x, _ in leaves}
        tensors["L1"] = L1
        order = ("Z", "phi", "a1", "L1", "C", "T", "R")
        rows = {}
        for i, nm in enumerate(order):
            x, (p, bs) = tensors[nm], flat[2 * i:2 * i + 2]
            assert p == x.data_ptr(), nm
            k = {"Z": m, "phi": 1, "a1": m, "L1": m * m, "C": m, "T": m * m,
                 "R": m * spec.k}[nm]
            rows[nm] = torch.as_strided(x, (B, k), (bs, 1),
                                        x.storage_offset())
        R = rows["R"].reshape(B, m, spec.k)
        R = torch.cat([R, R.new_zeros(B, m, m - spec.k)], dim=-1)
        got = torch.cat([rows["a1"], rows["L1"], rows["C"],
                         R.reshape(B, -1), rows["T"]], dim=1)
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   msg=f"{kind} {label}")
    # one factor per distinct P1: the same tensor gives the same factor,
    # an edit in place (a new version) a new one
    P1 = spec0.P1.clone()
    a = ck._p1_chol(P1)
    assert ck._p1_chol(P1) is a
    P1.mul_(4.0)
    b = ck._p1_chol(P1)
    assert b is not a
    torch.testing.assert_close(b, 2.0 * a, rtol=1e-6, atol=0)


@pytest.mark.parametrize("N,m,item,bsf,want", [
    (200, 1, 4, True, (32, 4, 7)),      # pm_bsf_N200
    (64, 2, 4, False, (32, 4, 2)),      # da_psi_N64
    (256, 2, 4, False, (32, 4, 8)),     # psi_N256's correction
    (512, 2, 4, False, (64, 1, 8)),
    (300, 2, 4, False, (64, 1, 7)),
    (257, 2, 8, False, (64, 1, 8)),
    (300, 1, 4, True, (64, 1, 7)),
    (40, 4, 8, False, (32, 3, 2)),      # 12.5 KB a row: 3 a block
    (33, 3, 4, True, (32, 4, 2)),
    (2, 4, 8, True, (32, 4, 2)),
    (512, 4, 8, True, (64, 1, 8))])
def test_big_geometry_holds_every_particle(N, m, item, bsf, want):
    """The launch of the large-ensemble kernel: threads a row, rows a block
    and slots a thread as the rule picks them, every particle held by one
    thread's consecutive slots and no thread holding more than its slots,
    an instantiated slot count, at most 128 threads a block, and several
    rows a block only inside the default 48 KB of shared memory."""
    geo = ck.big_geometry(N, m, item, bsf)
    assert geo[:3] == want
    T, rows, pmax, smem = geo
    lo = [r * N // T for r in range(T + 1)]
    assert lo[0] == 0 and lo[-1] == N
    assert all(0 <= lo[r + 1] - lo[r] <= pmax for r in range(T))
    assert pmax in ck.big_pmax_choices(item, m)
    assert T * rows <= ck.BIG_MAX_THREADS and (T == 32 or rows == 1)
    assert smem == rows * ck.big_row_elems(N, m, bsf) * item
    assert rows == 1 or smem <= ck.SMEM_DEFAULT


def test_big_geometry_refuses_and_matches_the_kernel_constants():
    """More particles than two warps' slots are refused; the constants the geometry is computed from are the kernel's
    (read from csrc/particle_big.cuh)."""
    import re
    with pytest.raises(ValueError, match="more than"):
        ck.big_geometry(513, 2, 4, False)
    src = (ck.CSRC / "particle_big.cuh").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = ([\d *]+);", src))
    assert eval(const["kChunk"]) == ck.BIG_CHUNK
    assert eval(const["kMaxWarpsRow"]) == ck.BIG_MAX_WARPS
    assert eval(const["kMaxThreadsBig"]) == ck.BIG_MAX_THREADS
    assert eval(const["kSmemDefault"]) == ck.SMEM_DEFAULT
    assert eval(const["kMaxNBig"]) == ck.MAX_N_BIG
    for p in (2, 7, 8):
        assert f"case {p}: return launch_big<R, M, BSF, {p}>" in src
    assert "sizeof(R) == 4 && M <= 2" in src
    assert ck.big_pmax_choices(4, 2) == (2, 7, 8)
    assert ck.big_pmax_choices(8, 2) == ck.big_pmax_choices(4, 3) == (2, 8)


def test_strided_refuses_what_the_kernels_do_not_take():
    x = torch.zeros(3, 7)
    with pytest.raises(ValueError, match="batch 3 does not match 4"):
        ck._strided(x, 4, 7, "D")
    with pytest.raises(ValueError, match="7 time points, expected 8"):
        ck._strided(x, 3, 8, "D")
    with pytest.raises(ValueError, match="1 time points, expected 7$"):
        ck._strided(torch.zeros(3, 1), 3, 7, "y", full=True)
    assert ck._strided(torch.zeros(3, 1), 3, 7, "H")[1:] == [1, 0]
    assert ck._strided(torch.zeros(7), 3, 7, "y", full=True)[1:] == [0, 1]
    with pytest.raises(ValueError, match="batch 2 does not match 5"):
        ck.system_leaves(_model("ar1_lg", torch.float64).build(
            torch.zeros(2, 5, dtype=torch.float64)), 5)


# ---------------------------------------------------------------------------
# the degenerate-model rule inside the kernels
# ---------------------------------------------------------------------------

def _degenerate_twin(spec, B):
    """What kalman_ll_kernel and fast_smoother_ll_kernel do, in plain
    Python: H read as the filter reads it, H^2 added step by step (a
    constant H n times), R R' formed from the R read, |R R'| summed entry by
    entry, the total against ZERO_TOL in the working type."""
    n, m = spec.n, spec.m
    dt = spec.y.dtype
    _, bs, ts = ck._strided(spec.H, B, n, "H")
    H = torch.as_strided(spec.H, (B, n), (bs, ts), spec.H.storage_offset())
    R = dict((nm, (x, s)) for nm, x, s in
             ck.system_leaves(spec, B))["R"]
    Rm = torch.as_strided(R[0], (B, m * spec.k), (R[1], 1),
                          R[0].storage_offset()).reshape(B, m, spec.k)
    out = []
    for b in range(B):
        hsum = torch.zeros((), dtype=dt)
        for t in range(n):
            hsum = hsum + H[b, t] * H[b, t]
        rr = torch.zeros((), dtype=dt)
        for i in range(m):
            for j in range(m):
                acc = torch.zeros((), dtype=dt)
                for k in range(spec.k):
                    acc = acc + Rm[b, i, k] * Rm[b, j, k]
                rr = rr + acc.abs()
        out.append(bool(hsum + rr < torch.tensor(tkalman.ZERO_TOL,
                                                 dtype=dt)))
    return torch.tensor(out)


def _threshold_arrays(per_time_h):
    """n = 20, m = 2 models on both sides of ZERO_TOL: (0) sds 1e-6 / 1e-5,
    degenerate; (1) n H^2 = 1.02e-8, R of 1e-7: just above; (2) n H^2 =
    0.98e-8: just below; (3) as (2), but with a per-time H one H is NaN,
    which keeps the row finite; (4) an ordinary row."""
    rng = np.random.default_rng(11)
    n, m, B = 20, 2, 5
    h = np.array([1e-6, np.sqrt(1.02e-8 / n), np.sqrt(0.98e-8 / n),
                  np.sqrt(0.98e-8 / n), 1.0])
    r = np.array([1e-5, 1e-7, 1e-7, 1e-7, 0.3])
    H = np.repeat(h[:, None], n if per_time_h else 1, axis=1)
    if per_time_h:
        H[3, 5] = np.nan
    return dict(y=rng.normal(size=(B, n)), Z=np.ones((B, 1, m)),
                H=H, T=np.broadcast_to(np.eye(m), (B, 1, m, m)).copy(),
                R=r[:, None, None, None] * np.eye(m)[None, None],
                a1=np.zeros((B, m)),
                P1=np.broadcast_to(np.eye(m), (B, m, m)).copy(),
                D=rng.normal(size=(B, n)), C=np.zeros((B, 1, m)))


@pytest.mark.parametrize("per_time_h", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_degenerate_twin_follows_the_kernel_wrapper_rule(dtype, per_time_h):
    d = _threshold_arrays(per_time_h)
    B = d["y"].shape[0]
    spec = lgspec_from_numpy(d, device="cpu", dtype=dtype)
    twin = _degenerate_twin(spec, B)
    want = torch.tensor([True, False, True, not per_time_h, False])
    assert torch.equal(twin, want)
    assert torch.equal(tkalman.degenerate_h2rr(spec), want)
    jspec = JLGSpec(**{k: jnp.asarray(v) for k, v in d.items()})
    kern = np.asarray(fused_log_likelihood_batched(jspec, B, interpret=True))
    assert np.array_equal(np.isneginf(kern), want.numpy())
    # the wrapper on the CPU: the plain version under the same rule
    ll = ck.log_likelihood(spec)
    assert torch.equal(torch.isneginf(ll), want)


# ---------------------------------------------------------------------------
# the packed argument structs against their C definitions
# ---------------------------------------------------------------------------

def _c_fields(struct_name):
    """The struct's fields in order as "q" (long long) and "d" (double),
    read from the C sources; SeriesArg and SystemArg expanded."""
    src = "".join(p.read_text() for p in sorted(ck.CSRC.glob("*.cu*")))
    nested = {"SeriesArg": "qqq", "LeafArg": "qq"}
    nested["SystemArg"] = nested["LeafArg"] * 7 + "q"

    def body(name):
        i = src.index(f"struct {name} {{")
        return src[i + len(name) + 9:src.index("};", i)]

    out = ""
    for decl in body(struct_name).split(";"):
        decl = " ".join(ln.split("//")[0] for ln in decl.splitlines())
        words = decl.replace(",", " ").split()
        if not words:
            continue
        if words[:2] == ["long", "long"]:
            out += "q" * (len(words) - 2)
        elif words[0] == "double":
            out += "d" * (len(words) - 1)
        else:
            out += nested[words[0].replace("bssm::", "")] * (len(words) - 1)
    return out


@pytest.mark.parametrize("name,layout", [("LaplaceArgs", ck._SOLVE_ARGS),
                                         ("StepArgs", ck._STEP_ARGS),
                                         ("KalmanArgs", ck._KALMAN_ARGS),
                                         ("RtsArgs", ck._RTS_ARGS),
                                         ("PsiArgs", ck._PSI_ARGS),
                                         ("BigLaunch", ck._BIG_ARGS)])
def test_packed_arguments_match_the_c_structs(name, layout):
    fmt = layout.format
    fmt = fmt.decode() if isinstance(fmt, bytes) else fmt
    expand = ""
    num = ""
    for ch in fmt.lstrip("="):
        if ch.isdigit():
            num += ch
        else:
            expand += ch * int(num or 1)
            num = ""
    assert expand == _c_fields(name)
    assert layout.size == 8 * len(expand)
