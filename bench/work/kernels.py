"""Operations and bytes that one application of each hand-written kernel's
computation needs, from its shapes alone.

These count what the computation needs, whatever implements it: each
input byte read once and each output byte written once, and the
operations of the formulation with the fewest.  No change of tiling,
chunk, recompute or fusion in the program moves them, so a kernel's share
of its least time (`bench.harness.peaks.least_time`) cannot pass 100 %.
They are copies, not imports, of the program's own counts, so that a
change to the program cannot move the yardstick.  Each returns (ops,
bytes, the peak rate its operations run at)."""

from __future__ import annotations

from typing import Tuple

from harness.peaks import BF16_FLOPS, FP32_FLOPS

Work = Tuple[float, float, float]


def causal_pairs(sq: int, sk: int) -> int:
    """(query, key) pairs a causal mask keeps for one sequence: query i
    sees keys 0..i (queries past the keys see them all)."""
    seen = min(sq, sk)
    return seen * (seen + 1) // 2 + (sq - seen) * sk


def flash_fwd(b: int, sq: int, sk: int, hq: int, hkv: int, d: int, causal: bool = True,
              itemsize: int = 2) -> Work:
    """S = Q K^T and O = P V over the kept pairs, a multiply-add (two
    operations) a (pair, head, channel) each; q, k and v read once, the
    output and the fp32 log-sum-exp (which the gradient needs) written
    once.  The softmax's exponentials are left out: fewer than a
    hundredth of the products' operations at these head sizes."""
    pairs = b * (causal_pairs(sq, sk) if causal else sq * sk)
    ops = 4 * pairs * hq * d
    nbytes = (2 * b * sq * hq * d + 2 * b * sk * hkv * d) * itemsize + b * hq * sq * 4
    return ops, nbytes, BF16_FLOPS


def flash_bwd(b: int, sq: int, sk: int, hq: int, hkv: int, d: int, causal: bool = True,
              itemsize: int = 2) -> Work:
    """The five products of the standard rule, a multiply-add each over the
    kept pairs: S = Q K^T (the forward keeps only O and the log-sum-exp,
    not P, so S is formed again), dP = dO V^T, dV = P^T dO, dQ = dS K and
    dK = dS^T Q.  Bytes: q, k, v, out and dout read, the fp32 log-sum-exp
    read, dq, dk and dv written, once each."""
    pairs = b * (causal_pairs(sq, sk) if causal else sq * sk)
    ops = 10 * pairs * hq * d
    nbytes = (4 * b * sq * hq * d + 4 * b * sk * hkv * d) * itemsize + b * hq * sq * 4
    return ops, nbytes, BF16_FLOPS


def rms_norm_fwd(rows: int, d: int, itemsize: int = 2) -> Work:
    """x read and y written once, the scale read once; four fp32
    operations an element (square, sum, normalise, scale), which no tensor
    core takes."""
    return 4 * rows * d, (2 * rows * d + d) * itemsize, FP32_FLOPS


def rms_norm_bwd(rows: int, d: int, itemsize: int = 2) -> Work:
    """x and dy read, dx written, the scale read and its gradient written,
    once each; the row's sum of squares again (2), dy * scale (1), the
    row's dot of that with x-hat (2), dx (3) and dscale's sum (2): ten
    fp32 operations an element."""
    return 10 * rows * d, (3 * rows * d + 2 * d) * itemsize, FP32_FLOPS


def ssm_fwd(b: int, s: int, h: int, p: int, n: int, itemsize: int = 2) -> Work:
    """The recurrent form, per (token, head): the decay and dt * x (P + 2),
    S = a S + (dt x) B^T (3 P N), y = S C (2 P N), y += D x (2 P): 5 P N +
    3 P operations, whatever chunked form computes it.  Bytes: x, B and C
    read and y written in x's type, dt (fp32) read, A_log and D read; the
    final state is not read by a training step and is not counted."""
    ops = b * s * h * (5 * p * n + 3 * p)
    nbytes = (2 * b * s * h * p + 2 * b * s * n) * itemsize + b * s * h * 4 + 2 * h * 4
    return ops, nbytes, BF16_FLOPS


def ssm_bwd(b: int, s: int, h: int, p: int, n: int, itemsize: int = 2) -> Work:
    """The recurrent form's gradient, per (token, head), sweeping back:
    the states formed again (3 P N), dS = a' dS' + dy C^T (3 P N), dC (2 P
    N), dB and d(dt x) (2 P N each), the decay's gradient (2 P N), and the
    per-channel terms (8 P): 14 P N + 8 P operations.  Bytes: x, dy, B and
    C read and dx, dB and dC written in x's type; dt read and ddt written
    in fp32; A_log and D read and their gradients written."""
    ops = b * s * h * (14 * p * n + 8 * p)
    nbytes = ((3 * b * s * h * p + 4 * b * s * n) * itemsize + 2 * b * s * h * 4
              + 4 * h * 4)
    return ops, nbytes, BF16_FLOPS
