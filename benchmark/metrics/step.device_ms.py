"""``step.device_ms``: the card's busy time a step (ms), the union of the
step's kernels and copies in the traced window over the steps run, in the
step cells (``drivers/step.py``)."""


def read(ctx):
    if not ctx.get("steps"):
        return None
    return ctx["summary"]["busy_s"] / ctx["steps"] * 1e3
