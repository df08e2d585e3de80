"""``device.idle_pct``: the share of the traced window in which no kernel
or copy ran on the card, in the step cells."""


def read(ctx):
    if not ctx.get("steps"):
        return None
    s = ctx["summary"]
    return (1.0 - s["busy_s"] / s["window_s"]) * 100.0
