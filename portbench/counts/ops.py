"""Operation and byte counts of the port's kernels, from their shapes.

Copied from the repo's ``chip_smoke.py`` (``kf_step_ops``, ``bwd_mean_ops``,
``laplace_pass_ops``, ``roofline``, ``bounds``, ``big_bounds``) so that the
yardstick stays fixed whatever later changes make of that script; the
portbench tests hold the copy equal to the original.  Peaks: one H100 SXM,
NVIDIA's data sheet (3.35 TB/s HBM3, 67 TFLOP/s float32 outside the tensor
cores, at the 700 W limit).
"""
from __future__ import annotations

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores


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
