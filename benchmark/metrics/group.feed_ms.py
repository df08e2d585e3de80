"""``group.feed_ms``: the port's span ``sdrm.group.feed`` a block (ms):
``BatchedRxGroup.feed`` copying a stream buffer into the accumulator and
the filled block out of it, up to its put on the group's queue."""

from benchmark.program_spans import read_ms


def read(ctx):
    return read_ms(ctx, "sdrm.group.feed")
