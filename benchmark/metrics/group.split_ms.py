"""``group.split_ms``: the port's span ``sdrm.group.split`` a block (ms):
every lane's symbols gathered from its chunks into one array."""

from benchmark.program_spans import read_ms


def read(ctx):
    return read_ms(ctx, "sdrm.group.split")
