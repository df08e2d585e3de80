"""The port's spans and counters (``sdrmodem_tpu_torch/utils/spans.py``)
in the served fast group, on the CPU.

A 4-client ``BatchedRxGroup`` of real fast ``RxSession``s serves blocks in
a closed loop (the next block is fed once every client has the last one's
symbols), as the benchmark's served cell does.  With the profiler off no
span is entered and nothing is recorded; under ``torch.profiler`` the
loop thread's spans land in the trace, the table counts every span, the
blocks and the queue's wait, and the clients' bytes are those of the run
without it.
Tolerance: none; the counts and the bytes are exact.
"""

import asyncio
import json
import sys
import threading

import numpy as np
import pytest
import torch
import torch.autograd.profiler
from torch.profiler import ProfilerActivity, profile

from sdrmodem_tpu_torch.server import wire
from sdrmodem_tpu_torch.server.config import RxSdrType, ServerConfig
from sdrmodem_tpu_torch.server.session import BatchedRxGroup, RxSession
from sdrmodem_tpu_torch.utils import spans

from tests.test_torch_fir import one_thread  # noqa: F401 (torch on one thread)
from tests.test_torch_server import PASS_START, TLE

BLOCK = 2048
CLIENTS = 4
GROUP_SPANS = ("sdrm.group.feed", "sdrm.group.rows", "sdrm.group.step", "sdrm.group.split")
LOOP_SPANS = GROUP_SPANS + ("sdrm.session.emit",)


class Writer:
    """A client's socket: the bytes it was sent."""

    def __init__(self):
        self.data = bytearray()

    def write(self, data: bytes):
        self.data += data

    async def drain(self):
        pass


def request(k: int) -> wire.RxRequest:
    return wire.RxRequest(
        rx_center_freq=437525000, rx_sampling_freq=48000, demod_baud_rate=4800,
        demod_decimation=2, demod_destination=wire.DemodDestination.SOCKET,
        doppler=wire.DopplerSettings(tle=TLE, latitude=537200000, longitude=475700000, altitude=0),
        fsk_settings=wire.FskDemodulationSettings(
            demod_fsk_deviation=5000, demod_fsk_transition_width=2000, demod_fsk_use_dc_block=True),
        file_settings=wire.FileSettings(filename="", start_time_seconds=PASS_START + 60 * k))


def serve(blocks: int, prof=None) -> list[bytes]:
    """Each client's bytes after ``blocks`` blocks, fed one at a time; the
    window profiled by ``prof`` where given."""
    config = ServerConfig()
    config.demod_mode = "fast"
    config.buffer_size = BLOCK
    config.rx_sdr_type = RxSdrType.FILE
    rng = np.random.default_rng(5)
    iq = (rng.standard_normal((blocks, BLOCK)) + 1j * rng.standard_normal((blocks, BLOCK))).astype(np.complex64)

    async def body():
        writers = [Writer() for _ in range(CLIENTS)]
        sessions = [RxSession(k, request(k), config, writers[k], dsp_device="cpu") for k in range(CLIENTS)]
        group = BatchedRxGroup(sessions[0].fsk_config, BLOCK, blocking=True, device="cpu")
        for s in sessions:
            group.attach(s)
        if prof is not None:
            prof.start()
        try:
            for k in range(blocks):
                await group.feed(iq[k])
                while group.blocks_processed <= k:
                    assert group._worker_task is not None and not group._worker_task.done()
                    await asyncio.sleep(0.002)
        finally:
            if prof is not None:
                prof.stop()
        await group.close()
        for s in sessions:
            s.finish_fast()
        return [bytes(w.data) for w in writers]

    return asyncio.run(body())


@pytest.fixture
def table():
    spans.clear()
    yield
    spans.clear()


def test_the_profilers_flag_is_where_spans_read_it():
    """``spans`` reads torch's process-wide flag: a torch that renamed it
    would trace nothing, silently."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_nothing_is_recorded_with_the_profiler_off(table, monkeypatch):
    entered = []
    monkeypatch.setattr(spans, "_Span", lambda *a: entered.append(a))
    assert spans.span("sdrm.a") is spans.span("sdrm.b")
    assert serve(2)
    spans.add("group.blocks", 1)
    assert entered == [] and spans.snapshot() == {}


def test_spans_and_counters_of_a_profiled_group(table, tmp_path):
    plain = serve(3)
    spans.clear()
    prof = profile(activities=[ProfilerActivity.CPU])
    traced = serve(3, prof)
    assert traced == plain and all(len(b) > 0 for b in plain)

    got = spans.snapshot()
    for name in GROUP_SPANS:
        assert got[name][0] == 3, name
    assert got["sdrm.session.emit"][0] == 3 * CLIENTS
    assert got["group.blocks"] == (3, 3.0)
    assert got["group.queue_wait_s"][0] == 3 and got["group.queue_wait_s"][1] > 0
    assert all(got[name][1] > 0 for name in LOOP_SPANS)

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name") in LOOP_SPANS]
    for name in GROUP_SPANS:
        assert sum(e["name"] == name for e in events) == 3, name
    assert sum(e["name"] == "sdrm.session.emit" for e in events) == 3 * CLIENTS
    # the five loop-thread spans follow one another without overlapping
    runs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events)
    assert len(runs) == 4 * 3 + 3 * CLIENTS
    assert all(b <= c for (_, b), (c, _) in zip(runs, runs[1:]))


def test_the_table_loses_no_update_across_threads(table):
    """The loop and the step's thread both write the table: 16 threads
    adding at once, the interpreter switching every microsecond."""

    def work():
        for _ in range(2000):
            spans.add("group.blocks", 1)
            with spans.span("sdrm.thread"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = spans.snapshot()
    assert got["group.blocks"] == (32000, 32000.0)
    assert got["sdrm.thread"][0] == 32000
