"""``group.step_ms``: the port's span ``sdrm.group.step`` a block (ms): the
step in its worker thread as the event loop waits for it, the hand-off,
the copy in, the launches, the wait for the card, the copy out and the
hand-back."""

from benchmark.program_spans import read_ms


def read(ctx):
    return read_ms(ctx, "sdrm.group.step")
