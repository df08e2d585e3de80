"""``step.launches``: kernels launched on the card a step, counted in the
traced window (copies and sets not counted), in the step cells."""

from benchmark.tracing import DEVICE_WORK


def read(ctx):
    if not ctx.get("steps"):
        return None
    n = sum(k["launches"] for name, k in ctx["summary"]["kernels"].items() if name not in DEVICE_WORK)
    return n / ctx["steps"]
