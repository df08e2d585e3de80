"""``step.device_ms.served``: the card's busy time a block (ms) as the
fast group runs the step, the union of kernels and copies in the traced
window over the blocks served."""


def read(ctx):
    if not ctx.get("blocks"):
        return None
    return ctx["summary"]["busy_s"] / ctx["blocks"] * 1e3
