"""``group.host_ms``: the time a block (ms) in which no kernel or copy ran
on the card while the fast group served it: the host's work of
``BatchedRxGroup`` and ``RxSession`` (Doppler rows, tables, copies in and
out, the lane split and each client's emit) and the launches."""


def read(ctx):
    if not ctx.get("blocks"):
        return None
    s = ctx["summary"]
    return (s["window_s"] - s["busy_s"]) / ctx["blocks"] * 1e3
