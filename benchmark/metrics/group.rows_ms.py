"""``group.rows_ms``: the port's span ``sdrm.group.rows`` a block (ms): the
lane resets, the stream's (2, B) pair, each lane's Doppler rows (SGP4
once a second of signal) and the tables ``segment_tables`` builds."""

from benchmark.program_spans import read_ms


def read(ctx):
    return read_ms(ctx, "sdrm.group.rows")
