"""The least work the demod step's layers need, and the card's peaks.

Each function gives (bytes, flops) that the algorithm has to move and do
at a shape, counted as the roofline counts them: each input byte read
once, each output byte written once, the operations of the algorithm and
not of a kernel's design.  ``bound_ms`` turns them into the least time on
the card; a layer's roofline share is that time over the time its kernels
took in the trace.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def nco_cost(rows: int, c: int, s_rows: int, covered: float) -> tuple[float, float]:
    """The Doppler NCO alone: the (rows, 2C) block read and written once,
    the four (S, C) tables read once; ~56 flops a lane-sample a row covers
    (~10 for the row's two-level ramp, ~40 for the sincos, 6 for the
    rotation).  The rows are disjoint: a kernel that tests every row at
    every sample does work beyond this."""
    return 4 * (2 * rows * 2 * c + 4 * s_rows * c), 56 * covered


def front_cost(c: int, b: int, t1: int, t2: int, t3: int, d: int, *, fanout: bool,
               s_rows: int = 0, covered: float = 0.0) -> tuple[float, float]:
    """NCO -> LPF1 -> quad demod -> LPF2 -> DC blocker over a (B, C) block:
    the input read once (in the fanout layout one shared (2, B) stream, not
    B x 2C words), the histories and taps read and written once, y3
    written once; two flops a tap of LPF1 (on I and Q) and LPF2, ~16 a
    quad-demod output (6 for the conjugate product, ~10 for the table
    arctangent and the gain) and 13 a DC-blocker output: its four length-L
    moving averages as running sums (an add, a subtract and a scale each)
    and one subtract.  A (4L-3)-tap FIR form of the DC blocker is work
    beyond this bound.  With Doppler rows (``s_rows`` > 0) the tables and
    the NCO's flops of ``nco_cost``."""
    n2 = b // d
    hist = (t1 - 1) * 2 * c + 2 * c + (t2 - 1) * c + max(t3 - 1, 0) * c
    words = (2 * b if fanout else b * 2 * c) + n2 * c + 2 * hist + t1 + t2 + t3 + 257
    flops = 2 * (b * 2 * c * t1 + n2 * c * t2) + 16 * b * c + (13 * n2 * c if t3 else 0)
    if s_rows:
        words += 4 * s_rows * c
        flops += nco_cost(b, c, s_rows, covered)[1]
    return 4 * words, flops


def clock_cost(n: int, c: int, sfx: int, n_chunks: int, k: int, symbols: float) -> tuple[float, float]:
    """M&M over (n, C) rows of y3: y3, the suffix, the state and the
    (129, 8) bank read once, K symbol slots a chunk, the counts and the
    state written once; ~30 flops a symbol emitted (the interpolator's 8
    products and 7 sums, ~15 for the loop update)."""
    words = n * c + sfx * c + 4 * c + 129 * 8 + n_chunks * k * c + n_chunks * c + 4 * c
    return 4 * words, 30 * symbols


def step_cost(c: int, b: int, t1: int, t2: int, t3: int, d: int, *, fanout: bool, s_rows: int,
              covered: float, sfx: int, n_chunks: int, k: int, symbols: float) -> tuple[float, float]:
    """The front and the clock as one step, y3 kept on the chip: the
    front's bytes less y3, the clock's state in and out, the bank, the
    symbol slots and counts written once; the front's flops and ~30 a
    symbol emitted."""
    fb, ff = front_cost(c, b, t1, t2, t3, d, fanout=fanout, s_rows=s_rows, covered=covered)
    words = fb // 4 - (b // d) * c + 2 * sfx * c + 8 * c + 129 * 8 + n_chunks * k * c + n_chunks * c
    return 4 * words, ff + 30 * symbols


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time on the card, ms, and which of bytes or operations
    sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
