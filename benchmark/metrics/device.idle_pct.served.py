"""``device.idle_pct.served``: the share of the traced window in which no
kernel or copy ran on the card, in the served cell
(``drivers/group.py``)."""


def read(ctx):
    if not ctx.get("blocks"):
        return None
    s = ctx["summary"]
    return (1.0 - s["busy_s"] / s["window_s"]) * 100.0
