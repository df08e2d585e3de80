"""What the port's own spans and counters (``sdrmodem_tpu_torch/utils/
spans.py``) recorded while the window was traced, read in the run's own
process once the window is over: totals by name.  A port without that
module, or a run in which a name was never recorded, gives nothing.

Totals are read a block of the served group: over the port's own counter
``group.blocks`` (the blocks it stepped while recording), so that a
span's total and the count it is divided by come from the same run of
the program."""

from __future__ import annotations

import importlib

BLOCKS = "group.blocks"


def table() -> dict[str, tuple[int, float]]:
    """name -> (count, total); empty where the port records no spans."""
    try:
        spans = importlib.import_module("sdrmodem_tpu_torch.utils.spans")
    except ImportError:
        return {}
    return spans.snapshot()


def ms_a_block(ctx: dict, *names: str) -> tuple[float, int] | None:
    """The totals of ``names`` (seconds) summed, in ms a block the group
    stepped, and that count of blocks; None outside a served cell (no
    ``ctx["blocks"]``), or where the group counted no block or a name has
    no count."""
    if not ctx.get("blocks"):
        return None
    got = table()
    n = got.get(BLOCKS, (0, 0.0))[0]
    if not n or not all(got.get(name, (0, 0.0))[0] for name in names):
        return None
    return sum(got[name][1] for name in names) / n * 1e3, n


def read_ms(ctx: dict, *names: str) -> float | None:
    """``ms_a_block``'s ms alone."""
    got = ms_a_block(ctx, *names)
    return None if got is None else got[0]
