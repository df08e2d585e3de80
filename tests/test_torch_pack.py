"""The lane split: ``ops/pack.py:pack_lanes`` and the fast group that
uses it.

The reference is the per-chunk loop the group split its symbols with
before ``pack_lanes``: for each lane, its chunks' valid slots
``symbols[lane, t, :counts[lane, t]]`` concatenated, a lane with none
left out.  On the CPU the plain version is held to it at small random
shapes (zero counts, chunks filled to K, a lane with no symbols), in the
contiguous layout and the time-major one the step returns, and at the
step's own shapes (128 lanes x 128 chunks x 530 slots, and 512 x 512 x
146, ``chunk_plan`` at those widths).  The group, unsharded and on two
shards of one device, emits each lane's bytes as the loop splits the same
step output, and under the profiler counts ``group.packed`` once a shard
a block.  On the card the kernel equals the plain version at the same
shapes, in two launches a call: ``python -m pytest --noconftest
tests/test_torch_pack.py`` (this file imports no JAX).
Tolerance: none; the bytes and offsets are exact.
"""

import asyncio

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.ops import pack as pack_ops
from sdrmodem_tpu_torch.ops.pack import pack_lanes, pack_lanes_plain
from sdrmodem_tpu_torch.server.session import BatchedRxGroup
from sdrmodem_tpu_torch.utils import spans

LUCKY7 = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)
# (lanes, chunks, K): small ones, then the step's at 128 and 512 lanes
SMALL = [(1, 1, 1), (7, 5, 12), (33, 3, 40), (40, 9, 130)]
STEP = [(128, 128, 530), (512, 512, 146)]


def loop_split(symbols: np.ndarray, counts: np.ndarray) -> dict[int, np.ndarray]:
    """Each lane's symbols as the group's per-chunk loop gathered them;
    a lane with none has no entry."""
    out = {}
    for lane in range(counts.shape[0]):
        parts = [symbols[lane, t, : counts[lane, t]] for t in range(counts.shape[1]) if counts[lane, t]]
        if parts:
            out[lane] = np.concatenate(parts)
    return out


def step_output(c: int, n: int, k: int, seed: int, time_major: bool = True):
    """Random symbols (C, n, K) int8 and counts (C, n) int32, laid out as
    the step returns them (time-major: permuted from (n, K, C) and (n, C))
    or contiguous.  The counts include zeros, chunks filled to K, and
    (beyond one lane) a lane with no symbols."""
    rng = np.random.default_rng(seed)
    sym = rng.integers(-128, 128, (n, k, c), dtype=np.int8)
    cnt = rng.integers(0, k + 1, (n, c)).astype(np.int32)
    cnt[rng.random((n, c)) < 0.2] = 0
    cnt[rng.random((n, c)) < 0.2] = k
    if c > 1:
        cnt[:, c // 2] = 0
    symbols = torch.from_numpy(sym).permute(2, 0, 1)
    counts = torch.from_numpy(cnt).T
    if not time_major:
        symbols, counts = symbols.contiguous(), counts.contiguous()
    return symbols, counts


def assert_packed_as_loop(flat, offsets, symbols, counts):
    flat, offsets = flat.cpu().numpy(), offsets.cpu().numpy()
    want = loop_split(symbols.numpy(), counts.numpy())
    c = counts.shape[0]
    assert offsets.shape == (c + 1,) and offsets[0] == 0
    total = int(offsets[-1])
    for lane in range(c):
        got = flat[offsets[lane] : offsets[lane + 1]]
        np.testing.assert_array_equal(got, want.get(lane, got[:0]), err_msg=f"lane {lane}")
    np.testing.assert_array_equal(flat[:total], np.concatenate([want[l] for l in sorted(want)] or [flat[:0]]))


@pytest.mark.parametrize("time_major", [True, False])
@pytest.mark.parametrize("shape", SMALL)
def test_plain_pack_matches_the_loop(shape, time_major):
    symbols, counts = step_output(*shape, seed=sum(shape), time_major=time_major)
    flat, offsets = pack_lanes(symbols, counts)
    assert len(flat) == int(offsets[-1])
    assert_packed_as_loop(flat, offsets, symbols, counts)


@pytest.mark.parametrize("shape", STEP)
def test_plain_pack_at_the_steps_shapes(shape):
    symbols, counts = step_output(*shape, seed=shape[0])
    assert symbols.stride() == (1, shape[2] * shape[0], shape[0])  # the step's layout
    flat, offsets = pack_lanes_plain(symbols, counts)
    assert_packed_as_loop(flat, offsets, symbols, counts)


def test_pack_clamps_counts_and_checks_its_inputs():
    symbols, counts = step_output(4, 3, 5, seed=1)
    wild = counts.clone()
    wild[0, 0], wild[1, 2] = -3, 99
    flat, offsets = pack_lanes(symbols, wild)
    assert_packed_as_loop(flat, offsets, symbols, wild.clamp(0, 5))
    with pytest.raises(ValueError):
        pack_lanes(symbols.float(), counts)
    with pytest.raises(ValueError):
        pack_lanes(symbols, counts[:, :2])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("time_major", [True, False])
@pytest.mark.parametrize("shape", SMALL + STEP)
def test_pack_kernel_matches_plain(cuda, shape, time_major):
    symbols, counts = step_output(*shape, seed=sum(shape) + 7, time_major=time_major)
    want_flat, want_off = pack_lanes_plain(symbols, counts)
    before = pack_ops.launches
    flat, offsets = pack_lanes(symbols.to(cuda), counts.to(cuda))
    torch.cuda.synchronize()
    assert pack_ops.launches - before == 2
    assert len(flat) == shape[0] * shape[1] * shape[2]
    assert torch.equal(offsets.cpu(), want_off)
    assert torch.equal(flat[: int(want_off[-1])].cpu(), want_flat)


# ---- the group


class Stub:
    """A fast lane's session as the group sees it: the symbols it got."""

    group = None
    lane = -1
    doppler = None

    def __init__(self):
        self.finished = asyncio.Event()
        self.emitted = []

    def note_progress(self, n):
        pass

    async def emit(self, symbols):
        self.emitted.append(np.array(symbols))


def noise(seed, n=2048):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def served(monkeypatch, shards: int, blocks: int, prof=None):
    """A group of all but its last 20 lanes live (so the last shard has
    live and idle lanes) stepping ``blocks`` blocks; lane 3's counts are
    zeroed in every step (a lane with no symbols).  Returns the stubs and each block's step outputs, every
    shard's lanes in order."""
    lanes = 128 * shards
    monkeypatch.setattr(BatchedRxGroup, "LANES", lanes)
    group = BatchedRxGroup(LUCKY7, 2048, device="cpu", devices=["cpu"] * shards)
    stubs = [Stub() for _ in range(lanes - 20)]
    for s in stubs:
        group.attach(s)
    outputs = []

    def capture(step, shard):
        def run(state, x, dop):
            state, symbols, counts = step(state, x, dop)
            if shard == 0:
                counts = counts.clone()
                counts[3] = 0
                outputs.append([])
            outputs[-1].append((symbols.clone(), counts.clone()))
            return state, symbols, counts

        return run

    group._steps = [capture(s, i) for i, s in enumerate(group._steps)]

    async def body():
        for k in range(blocks):
            await group.feed(noise(k))
            while group.blocks_processed <= k:
                assert not group._worker_task.done()
                await asyncio.sleep(0.002)
        await group.close()

    if prof is not None:
        prof.start()
    try:
        asyncio.run(body())
    finally:
        if prof is not None:
            prof.stop()
    return stubs, [(torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])) for out in outputs]


@pytest.mark.parametrize("shards", [1, 2])
def test_group_emits_the_loops_bytes(monkeypatch, shards):
    stubs, outputs = served(monkeypatch, shards, 2)
    assert len(outputs) == 2
    want = {lane: [] for lane in range(len(stubs))}
    for symbols, counts in outputs:
        for lane, syms in loop_split(symbols.numpy(), counts.numpy()).items():
            if lane < len(stubs):
                want[lane].append(syms)
    assert not want[3] and not stubs[3].emitted
    for lane, s in enumerate(stubs):
        assert len(s.emitted) == len(want[lane]), f"lane {lane}"
        for got, syms in zip(s.emitted, want[lane]):
            np.testing.assert_array_equal(got, syms, err_msg=f"lane {lane}")
    assert all(len(s.emitted) == 2 for k, s in enumerate(stubs) if k != 3)


@pytest.mark.parametrize("shards", [1, 2])
def test_group_counts_a_packing_a_shard_a_block(monkeypatch, shards):
    spans.clear()
    try:
        served(monkeypatch, shards, 2, profile(activities=[ProfilerActivity.CPU]))
        got = spans.snapshot()
    finally:
        spans.clear()
    assert got["group.packed"] == (2 * shards, 2.0 * shards)
    assert got["group.blocks"] == (2, 2.0)
    assert got["sdrm.group.split"][0] == 2 and got["sdrm.group.split"][1] > 0
