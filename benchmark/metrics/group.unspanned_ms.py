"""``group.unspanned_ms``: the window a block (ms) less the port's five
event-loop spans a block (``sdrm.group.feed``, ``.rows``, ``.step``,
``.split`` and ``sdrm.session.emit``, which do not overlap): the loop's
hops between the group's coroutines and the benchmark's own work.  Both
are a block the group counted (``group.blocks``)."""

from benchmark.program_spans import ms_a_block

SPANS = ("sdrm.group.feed", "sdrm.group.rows", "sdrm.group.step", "sdrm.group.split",
         "sdrm.session.emit")


def read(ctx):
    got = ms_a_block(ctx, *SPANS)
    if got is None:
        return None
    spanned, blocks = got
    return ctx["window_s"] / blocks * 1e3 - spanned
