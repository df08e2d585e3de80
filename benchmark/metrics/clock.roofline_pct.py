"""``clock.roofline_pct``: the clock's least time (``costs.clock_cost`` at
the cell's shape and the symbols the window emitted a step) over the traced
time of the clock kernel, named in ``clock.roofline_pct.patterns.txt``, a
step."""

from pathlib import Path

from benchmark import costs, tracing

PATTERNS = Path(__file__).with_name("clock.roofline_pct.patterns.txt")


def read(ctx):
    if not ctx.get("steps"):
        return None
    secs, _ = tracing.kernel_seconds(ctx["summary"], tracing.read_patterns(PATTERNS))
    if secs <= 0:
        return None
    n = ctx["block"] // ctx["d"]
    nbytes, flops = costs.clock_cost(n, ctx["lanes"], ctx["sfx"], ctx["n_chunks"], ctx["k"],
                                     ctx["symbols_per_step"])
    least_ms, _ = costs.bound_ms(nbytes, flops)
    return least_ms / (secs / ctx["steps"] * 1e3) * 100.0
