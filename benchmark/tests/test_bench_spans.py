"""The readers of the port's spans and counters (``program_spans.py`` and
the ``group.*_ms`` metrics) on a fabricated table: each gives its total in
ms a block the group counted, and nothing outside a served cell, without
the group's count, without its span, or on a port that records none."""

import sys

import pytest

from benchmark import core, program_spans

TABLE = {
    "sdrm.group.feed": (10, 0.010),
    "group.queue_wait_s": (10, 0.002),
    "sdrm.group.rows": (10, 0.030),
    "sdrm.group.step": (10, 0.120),
    "sdrm.group.split": (10, 0.400),
    "sdrm.session.emit": (1280, 0.020),
    "group.blocks": (10, 10.0),
}
# the window's count of blocks that landed (``blocks``) is one short of the
# group's: a block whose wait timed out has its spans in the totals, and
# the group's own count divides them
BLOCKS = {"blocks": 9, "window_s": 0.75}
STEPS = {"steps": 50, "window_s": 0.3}
READS = [
    ("group.feed_ms", 1.0),
    ("group.queue_ms", 0.2),
    ("group.rows_ms", 3.0),
    ("group.step_ms", 12.0),
    ("group.split_ms", 40.0),
    ("group.emit_ms", 2.0),
    ("group.unspanned_ms", 75.0 - 1.0 - 3.0 - 12.0 - 40.0 - 2.0),
]


@pytest.fixture
def table(monkeypatch):
    got = dict(TABLE)
    monkeypatch.setattr(program_spans, "table", lambda: got)
    return got


@pytest.mark.parametrize("name,want", READS)
def test_reader_gives_ms_a_block(table, name, want):
    assert core.metric_reader(name)(dict(BLOCKS)) == pytest.approx(want)


@pytest.mark.parametrize("name,want", READS)
def test_reader_finds_nothing_without_its_count_or_span(table, name, want):
    read = core.metric_reader(name)
    assert read({"window_s": 1.0}) is None
    assert read({**BLOCKS, "blocks": 0}) is None
    assert read(dict(STEPS)) is None  # a step cell's context has no blocks
    del table["group.blocks"]
    assert read(dict(BLOCKS)) is None
    table.clear()
    assert read(dict(BLOCKS)) is None


def test_the_table_is_the_ports_own():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdrmodem_tpu_torch.utils import spans

    spans.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with spans.span("sdrm.group.split"):
                torch.ones(4).sum()
            spans.add("group.queue_wait_s", 0.5)
        got = program_spans.table()
        assert got["sdrm.group.split"][0] == 1 and got["sdrm.group.split"][1] > 0
        assert got["group.queue_wait_s"] == (1, 0.5)
    finally:
        spans.clear()


def test_a_port_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "sdrmodem_tpu_torch.utils.spans", None)  # import raises
    assert program_spans.table() == {}
    for name, _ in READS:
        assert core.metric_reader(name)(dict(BLOCKS)) is None
