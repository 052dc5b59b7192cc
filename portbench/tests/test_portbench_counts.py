"""The copied operation and byte counts equal ``chip_smoke.py``'s at the
shapes of PERF.md's kernel table."""
import torch

import chip_smoke
from portbench.counts import ops

SHAPES = [(1024, 153, 2, 10), (4096, 153, 2, 10), (16384, 153, 2, 10),
          (8192, 945, 1, 64), (16384, 153, 2, 256)]


def test_step_counts_equal():
    for m in (1, 2, 3, 4):
        assert ops.kf_step_ops(m) == chip_smoke.kf_step_ops(m)
        assert ops.bwd_mean_ops(m) == chip_smoke.bwd_mean_ops(m)
        assert ops.laplace_pass_ops(m) == chip_smoke.laplace_pass_ops(m)


def test_bounds_equal():
    for B, n, m, N in SHAPES:
        for dt in (torch.float32, torch.float64):
            assert ops.bounds(B, n, m, N, dt, 5.0 * B) == \
                chip_smoke.bounds(B, n, m, N, dt, 5.0 * B)
            for kk in (1, 4, 8):
                for psi in (True, False):
                    assert ops.big_bounds(B, n, n, m, N, kk, dt, psi) == \
                        chip_smoke.big_bounds(B, n, n, m, N, kk, dt, psi)
    assert ops.roofline(1e9, 1e12) == chip_smoke.roofline(1e9, 1e12)
