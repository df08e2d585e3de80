"""``front.roofline_pct``: the front's least time (``costs.front_cost``:
the DC blocker as running sums, the fanout input read once, at the cell's
shape and Doppler rows) over the traced time of the kernels that do the
front's work, the fanout staging included, named in
``front.roofline_pct.patterns.txt``, a step."""

from pathlib import Path

from benchmark import costs, tracing

PATTERNS = Path(__file__).with_name("front.roofline_pct.patterns.txt")


def read(ctx):
    if not ctx.get("steps"):
        return None
    secs, _ = tracing.kernel_seconds(ctx["summary"], tracing.read_patterns(PATTERNS))
    if secs <= 0:
        return None
    c, b = ctx["lanes"], ctx["block"]
    t1, t2, t3 = ctx["taps"]
    nbytes, flops = costs.front_cost(c, b, t1, t2, t3, ctx["d"], fanout=ctx["fanout"],
                                     s_rows=ctx["s_rows"], covered=float(b) * c)
    least_ms, _ = costs.bound_ms(nbytes, flops)
    return least_ms / (secs / ctx["steps"] * 1e3) * 100.0
