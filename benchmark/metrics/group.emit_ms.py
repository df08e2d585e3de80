"""``group.emit_ms``: the port's spans ``sdrm.session.emit``, every client's,
a block (ms): each session's dump and socket writes, up to its drain."""

from benchmark.program_spans import read_ms


def read(ctx):
    return read_ms(ctx, "sdrm.session.emit")
