"""``group.queue_ms``: the port's counter ``group.queue_wait_s`` a block
(ms): the time from a block's put on the group's queue to the worker's
take of it."""

from benchmark.program_spans import read_ms


def read(ctx):
    return read_ms(ctx, "group.queue_wait_s")
