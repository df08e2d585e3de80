"""The plain reference against the port's plain path at a tiny size: the
same bits, the same Doppler rows, the same carried state."""

import numpy as np
import pytest
import torch

from benchmark import check, core, gen
from benchmark.reference.doppler import max_rows, tables
from benchmark.reference.fsk import Radio

B, C = 4096, 3
MIX = {"lanes": C, "block": B, "ring": 3, "snr_db": 20, "pass_spread_s": 600}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_run(cfg, xs, dops):
    from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
    from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline

    r = cfg["radio"]
    pipe = DemodPipeline(FskDemodConfig(r["sampling_freq"], r["baud_rate"], r["deviation"], r["decimation"],
                                        r["transition_width"], r["use_dc_block"]), B, device="cpu")
    step = pipe.make_batched_step_full("pallas", doppler=True, layout="fanout")
    st = pipe.init_full_state(C)
    states, outs = [], []
    for x, d in zip(xs, dops):
        states.append(st)
        st, sym, cnt = step(st, torch.from_numpy(x), tuple(torch.from_numpy(t) for t in d))
        outs.append(check.program_symbols(sym.numpy(), cnt.numpy()))
    return states, outs


@pytest.mark.parametrize("name", ["lucky7", "nusat"])
def test_reference_equals_the_port_plain_path(name):
    cfg = core.read_json(core.BENCH / "configs" / f"{name}.json")
    blocks = gen.stream_blocks(cfg, MIX, 2**31 + 3)
    xs = [np.stack([b.real, b.imag]).astype(np.float32) for b in blocks]
    dops = gen.doppler_ring(cfg, MIX, gen.client_starts(cfg, MIX, 2**31 + 3))
    states, outs = port_run(cfg, xs, dops)
    lanes = np.arange(C)
    segs = [check.Segment(xs[0:2], dops[0:2], None),
            check.Segment(xs[1:3], dops[1:3], check.ref_state(states[1], lanes))]
    numbers = check.compare(Radio.from_config(cfg), C, B, segs, [outs[0:2], outs[1:3]], C, "cpu", 1)
    assert numbers["off2_share"] == 0.0 and numbers["max_lsb"] == 0 and numbers["count_gap"] == 0
    assert numbers["symbols"] > 3 * C * B // 12


def test_doppler_rows_equal_the_port():
    from sdrmodem_tpu_torch.dsp.doppler import Doppler
    from sdrmodem_tpu_torch.utils.convert import segment_tables

    cfg = core.read_json(core.BENCH / "configs" / "lucky7.json")
    p = cfg["pass"]
    start = p["start_time_seconds"] + 123
    port = Doppler(latitude=p["latitude"], longitude=p["longitude"], altitude_km=p["altitude_km"],
                   sampling_freq=48000, center_freq=p["center_freq"], tle_lines=p["tle"],
                   start_time_seconds=start)
    ref = gen.client_doppler(cfg, start)
    for _ in range(30):
        a = port.device_segments(262144, +1)
        b = ref.block(262144)
        s = max_rows(262144, 48000)
        assert s == Doppler.max_rows(262144, 48000)
        for t, u in zip(segment_tables({0: a}, s, 1), tables([b], s)):
            np.testing.assert_array_equal(t, u)


def test_seeds_give_the_same_sizes_and_other_draws():
    cfg = core.read_json(core.BENCH / "configs" / "nusat.json")
    a, b = gen.stream_blocks(cfg, MIX, 1), gen.stream_blocks(cfg, MIX, 2**33 + 1)
    assert a.shape == b.shape == (3, B) and not np.array_equal(a, b)
    np.testing.assert_array_equal(a, gen.stream_blocks(cfg, MIX, 1))
    assert len(gen.client_starts(cfg, MIX, 5)) == C


def test_reservoir_is_uniform_and_seeded():
    counts = np.zeros(50)
    for seed in range(400):
        r = gen.Reservoir(2, seed)
        for i in range(50):
            r.offer(i)
        counts[r.items] += 1
    assert counts.sum() == 800 and counts.min() > 3 and counts.max() < 40
    r1, r2 = gen.Reservoir(3, 9), gen.Reservoir(3, 9)
    for i in range(100):
        r1.offer(i), r2.offer(i)
    assert r1.items == r2.items
