"""The port's sharding (``sdrmodem_tpu_torch/parallel/``) on meshes of CPU
shards, case for case with ``tests/test_parallel.py``.

Each case is held to two references:

- the port's own unsharded step on the same data, bit for bit: the
  channel classes against ``make_batched_step("pallas")`` and
  ``make_batched_step_full`` over every channel at once; the time-sharded
  functions against each stream fed alone (as a lane of one batch; the
  lanes are independent) through ``make_batched_step_full`` at block N / D,
  with the same Doppler tables where there are any;
- the JAX function on its 8-device CPU mesh (``tests/conftest.py``), at the
  tolerance JAX's own test states: symbol counts equal, every symbol within
  +-2 LSB and fewer than 1% differing.  The JAX references run the clock as
  ``clock_backend="scan"`` where JAX's test does, each computed once.

Beyond the mirrored cases: ``pipeline_schedule_report`` equals JAX's dict,
the mesh's ring shift, put and fetch, and the sharded states against the
JAX classes' global layout (``utils/convert.py``), exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from sdrmodem_tpu.dsp.doppler import Doppler as JaxDoppler
from sdrmodem_tpu.dsp.fsk_demod import FskDemodConfig as JaxConfig
from sdrmodem_tpu.parallel import channels as jax_channels
from sdrmodem_tpu.parallel import time_shard as jax_time
from sdrmodem_tpu_torch.dsp.doppler import Doppler
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.parallel import time_shard
from sdrmodem_tpu_torch.parallel.channels import ShardedChannelDemod, ShardedChannelDemodFull
from sdrmodem_tpu_torch.parallel.mesh import Mesh
from sdrmodem_tpu_torch.utils.convert import (
    doppler_tables_from_numpy,
    segment_tables,
    sharded_state_from_numpy,
    sharded_state_to_numpy,
)

from tests.test_doppler import ARGS
from tests.test_torch_fir import one_thread  # noqa: F401 (torch on one thread)

LUCKY7 = (48000, 4800, 5000, 2, 2000, True)
CFG = FskDemodConfig(*LUCKY7)
JCFG = JaxConfig(*LUCKY7)


def cpu_mesh(n, axis="time"):
    return Mesh(["cpu"] * n, axis)


def jax_mesh(n, axis):
    return JaxMesh(np.array(jax.devices()[:n]), axis_names=(axis,))


def fixture(resources_dir, name):
    return np.fromfile(resources_dir / name, dtype=np.complex64)


def noisy_streams(iq, count, n, offset, seed):
    """``count`` distinct streams: capture offsets ``offset`` apart, each
    with its own noise (``tests/test_parallel.py``'s)."""
    rng = np.random.default_rng(seed)
    return np.stack([
        iq[s * offset : s * offset + n] + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        for s in range(count)
    ]).astype(np.complex64)


def collect(symbols, counts, lane):
    symbols, counts = np.asarray(symbols), np.asarray(counts)
    return np.concatenate([symbols[lane, t, : counts[lane, t]] for t in range(counts.shape[1])])


def unsharded(streams, block, dopplers=None, backend="pallas", front="fused", chunk=1024):
    """Each stream fed alone, as a lane of one batch, through the port's
    full-block step at ``block``; with ``dopplers`` each lane's tables for
    each block, rows every 2000 samples, as the sharded path stages them."""
    s, n = streams.shape
    pipe = DemodPipeline(CFG, block, device="cpu")
    step = pipe.make_batched_step_full(backend, doppler=True, front=front, chunk=chunk)
    state = pipe.init_full_state(s)
    dops = {k: d for k, d in enumerate(dopplers or []) if d is not None}
    rows = Doppler.max_rows(block, CFG.sampling_freq, time_shard.DOPPLER_CADENCE)
    out = [[] for _ in range(s)]
    for t in range(-(-n // block)):
        blk = np.zeros((s, block), np.complex64)
        part = streams[:, t * block : (t + 1) * block]
        blk[:, : part.shape[1]] = part
        x = torch.from_numpy(np.stack([blk.real, blk.imag], axis=1).astype(np.float32))
        segs = {k: d.device_segments(block, +1, max_batch=time_shard.DOPPLER_CADENCE) for k, d in dops.items()}
        tables = doppler_tables_from_numpy(segment_tables(segs, rows, s), s, device="cpu") if dops else None
        state, sym, cnt = step(state, x, tables)
        for k in range(s):
            out[k].append(collect(sym, cnt, k))
    return [np.concatenate(o) for o in out]


def within_jax_tolerance(got, want, what=""):
    """JAX's own test's bound: counts equal, +-2 LSB, < 1% of symbols differing."""
    assert len(got) == len(want), f"{what}: {len(got)} symbols vs JAX's {len(want)}"
    diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 2 and (diff > 0).mean() < 0.01, f"{what}: max {diff.max()}, {(diff > 0).mean()}"


def within_golden(got, golden, what=""):
    m = min(len(got), len(golden))
    diff = np.abs(got[:m].astype(np.int32) - golden[:m].astype(np.int32))
    assert diff.max() <= 2, f"{what}: {(diff > 2).sum()} beyond +-2 LSB of the golden"
    return m


# ---- the mesh


def test_mesh_ring_shift_put_fetch():
    """ring_shift hands shard i - 1's value to shard i (tensors and named
    tuples alike); put and fetch are inverses; a mesh needs a device."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import ClockFullState, initial_full_state

    mesh = cpu_mesh(4)
    assert mesh.size == mesh.local == 4 and list(mesh.shards) == [0, 1, 2, 3] and not mesh.staged
    arr = np.arange(4 * 3 * 2, dtype=np.float32).reshape(4, 3, 2)
    xs = mesh.put(arr)
    assert [tuple(x.shape) for x in xs] == [(3, 2)] * 4
    np.testing.assert_array_equal(mesh.fetch(xs), arr)
    np.testing.assert_array_equal(mesh.fetch(mesh.ring_shift(xs)), np.roll(arr, 1, axis=0))
    states = [initial_full_state(float(p + 2), 3, device="cpu") for p in range(4)]
    shifted = mesh.ring_shift(states)
    assert all(isinstance(s, ClockFullState) for s in shifted)
    assert [float(s.omega[0]) for s in shifted] == [5.0, 2.0, 3.0, 4.0]
    with pytest.raises(ValueError, match="leading axis"):
        mesh.put(arr[:3])
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])


# ---- channels (tests/test_parallel.py:23, :45, :79, :116)


@pytest.fixture(scope="module")
def ragged_16(resources_dir):
    """JAX's ShardedChannelDemod over 8 devices: 16 channels of the lucky7
    capture's first 16384 samples, one block."""
    iq = fixture(resources_dir, "lucky7.expected.cf32")[:16384]
    sharded = jax_channels.ShardedChannelDemod(JCFG, 16384, 16, jax_mesh(8, "channel"), exact=False)
    _, sym, cnt = sharded.step(sharded.init_state(), sharded.place_input(np.tile(iq, (16, 1))))
    return iq, np.asarray(sym), np.asarray(cnt)


def test_channel_sharded_equals_single(resources_dir, ragged_16):
    iq, jsym, jcnt = ragged_16
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)
    channels = 16
    sharded = ShardedChannelDemod(CFG, 16384, channels, cpu_mesh(8, "channel"))
    batch = np.tile(iq, (channels, 1))
    state, symbols, counts = sharded.step(sharded.init_state(), sharded.place_input(batch))
    assert len(state) == 8 and symbols.shape[0] == counts.shape[0] == channels
    counts, out = counts.numpy(), symbols.numpy()
    assert (counts == counts[0]).all()
    for c in range(channels):
        np.testing.assert_array_equal(out[c, : counts[0]], out[0, : counts[0]])
    within_golden(out[0, : counts[0]], golden, "channel 0")
    # the port's unsharded ragged step over every channel, bit for bit
    pipe = DemodPipeline(CFG, 16384, device="cpu")
    x = torch.from_numpy(np.stack([batch.real, batch.imag], axis=1).astype(np.float32))
    _, ref_sym, ref_cnt = pipe.make_batched_step("pallas")(
        pipe.init_state(channels=channels), x, torch.full((channels,), 16384, dtype=torch.int32))
    np.testing.assert_array_equal(counts, ref_cnt.numpy())
    np.testing.assert_array_equal(out, ref_sym.numpy())
    for c in (0, channels - 1):
        within_jax_tolerance(out[c, : counts[c]], jsym[c, : jcnt[c]], f"channel {c}")


def test_channel_sharded_state_carries_between_blocks(resources_dir):
    iq = fixture(resources_dir, "lucky7.expected.cf32")[:16384]
    block = 8192

    def port_two_blocks(channels, mesh):
        sharded = ShardedChannelDemod(CFG, block, channels, mesh)
        state, outs = sharded.init_state(), []
        for i in range(2):
            x = sharded.place_input(np.tile(iq[i * block : (i + 1) * block], (channels, 1)))
            state, symbols, count = sharded.step(state, x)
            outs.append(symbols[0, : int(count[0])].numpy())
        return np.concatenate(outs)

    two_block = port_two_blocks(8, cpu_mesh(8, "channel"))
    whole = ShardedChannelDemod(CFG, 16384, 8, cpu_mesh(8, "channel"))
    _, symbols, count = whole.step(whole.init_state(), whole.place_input(np.tile(iq, (8, 1))))
    np.testing.assert_array_equal(two_block, symbols[0, : int(count[0])].numpy())
    # two shards of one channel each against one shard of both: the same bits
    np.testing.assert_array_equal(port_two_blocks(2, cpu_mesh(2, "channel")),
                                  port_two_blocks(2, cpu_mesh(1, "channel")))

    jax_sharded = jax_channels.ShardedChannelDemod(JCFG, block, 8, jax_mesh(8, "channel"), exact=False)
    state, ref = jax_sharded.init_state(), []
    for i in range(2):
        x = jax_sharded.place_input(np.tile(iq[i * block : (i + 1) * block], (8, 1)))
        state, symbols, count = jax_sharded.step(state, x)
        ref.append(np.asarray(symbols)[0, : int(np.asarray(count)[0])])
    within_jax_tolerance(two_block, np.concatenate(ref), "two blocks")


def test_channel_sharded_full_path(resources_dir):
    """The production full-block step a shard: every lane equal, equal to
    the port's unsharded full-block step, within JAX's tolerance of JAX's
    sharded class; the state crosses to JAX's global layout and back, and
    JAX's state carries into the port."""
    iq = fixture(resources_dir, "lucky7.expected.cf32")[:8192]
    channels = 16
    sharded = ShardedChannelDemodFull(CFG, 8192, channels, cpu_mesh(8, "channel"), clock_backend="scan")
    state, symbols, counts = sharded.step(sharded.init_state(), sharded.place_input(np.tile(iq, (channels, 1))))
    assert tuple(counts.shape[:1]) == (channels,) and (counts == counts[0:1]).all() and counts.sum() > 0
    lane0 = collect(symbols, counts, 0)
    for c in range(1, channels):
        np.testing.assert_array_equal(collect(symbols, counts, c), lane0)
    np.testing.assert_array_equal(lane0, unsharded(iq[None], 8192, backend="scan")[0])

    jsharded = jax_channels.ShardedChannelDemodFull(JCFG, 8192, channels, jax_mesh(8, "channel"),
                                                    clock_backend="scan")
    jstate, jsym, jcnt = jsharded.step(jsharded.init_state(), jsharded.place_input(np.tile(iq, (channels, 1))))
    within_jax_tolerance(lane0, collect(jsym, jcnt, 0), "lane 0")
    # the state crosses to the JAX class's global layout and back unchanged
    glob = sharded_state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(glob), jax.tree.leaves(jstate)):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = sharded_state_from_numpy(glob, ["cpu"] * 8, channels)
    for a, b in zip(jax.tree.leaves(sharded_state_to_numpy(back)), jax.tree.leaves(glob)):
        np.testing.assert_array_equal(a, b)
    # JAX's state after the first block carries into the port: the next
    # block stepped from it is within JAX's tolerance of JAX's own next block
    nxt = np.tile(fixture(resources_dir, "lucky7.expected.cf32")[8192:16384], (channels, 1))
    carried = sharded_state_from_numpy(jax.tree.map(np.asarray, jstate), ["cpu"] * 8, channels)
    _, symbols, counts = sharded.step(carried, sharded.place_input(nxt))
    _, jsym, jcnt = jsharded.step(jstate, jsharded.place_input(nxt))
    within_jax_tolerance(collect(symbols, counts, 5), collect(jsym, jcnt, 5), "lane 5, carried from JAX")


def test_channel_sharded_production_kernels(resources_dir):
    """The production clock (B2's plain version on the CPU) under the
    sharded class equals the port's unsharded fused step (``front="step"``
    at a 256-row chunk, the JAX test's SDRM_STEP_CHUNK) symbol for symbol,
    and JAX's sharded class with its Pallas clock in interpret mode within
    its test's tolerance."""
    iq = fixture(resources_dir, "lucky7.expected.cf32")[:2048]
    channels = 8
    sharded = ShardedChannelDemodFull(CFG, 2048, channels, cpu_mesh(8, "channel"), clock_backend="pallas")
    _, symbols, counts = sharded.step(sharded.init_state(), sharded.place_input(np.tile(iq, (channels, 1))))
    assert (counts == counts[0:1]).all() and counts.sum() > 0
    lane0 = collect(symbols, counts, 0)
    for c in range(1, channels):
        np.testing.assert_array_equal(collect(symbols, counts, c), lane0)
    assert DemodPipeline(CFG, 2048, device="cpu").fused_step_available(1, 256)
    np.testing.assert_array_equal(lane0, unsharded(iq[None], 2048, front="step", chunk=256)[0])

    jsharded = jax_channels.ShardedChannelDemodFull(JCFG, 2048, channels, jax_mesh(8, "channel"),
                                                    clock_backend="pallas")
    _, jsym, jcnt = jsharded.step(jsharded.init_state(), jsharded.place_input(np.tile(iq, (channels, 1))))
    within_jax_tolerance(lane0, collect(jsym, jcnt, 0), "lane 0")


def test_channel_classes_refuse_what_jax_refuses():
    """The same ValueErrors for the same arguments: channels that do not
    divide over the shards, and past 128 channels a per-shard count that is
    not a multiple of 128."""
    with pytest.raises(ValueError, match="divide evenly"):
        ShardedChannelDemod(CFG, 4096, 10, cpu_mesh(4, "channel"))
    with pytest.raises(ValueError, match="divide evenly"):
        ShardedChannelDemodFull(CFG, 4096, 10, cpu_mesh(4, "channel"))
    with pytest.raises(ValueError, match="lane multiple"):
        ShardedChannelDemodFull(CFG, 4096, 192, cpu_mesh(2, "channel"))
    for cls in (jax_channels.ShardedChannelDemodFull,):
        with pytest.raises(ValueError, match="lane multiple"):
            cls(JCFG, 4096, 192, jax_mesh(2, "channel"), clock_backend="scan")
    assert ShardedChannelDemodFull(CFG, 4096, 256, cpu_mesh(2, "channel")).local == 128


# ---- time (tests/test_parallel.py:65, :158, :212, :222, :243, :288, :318)


def test_time_sharded_equals_unsharded(resources_dir):
    iq = fixture(resources_dir, "lucky7.expected.cf32")[:32768]
    symbols, count = time_shard.demod_time_sharded(iq, CFG, cpu_mesh(8), clock_backend="scan")
    assert count == len(symbols)
    np.testing.assert_array_equal(symbols, unsharded(iq[None], 4096, backend="scan")[0])
    jsym, jcount = jax_time.demod_time_sharded(iq, JCFG, jax_mesh(8, "time"), clock_backend="scan")
    assert count == jcount
    within_jax_tolerance(symbols, jsym, "stream")


def test_pipelined_streams_equal_unsharded_full_block(resources_dir):
    n_dev, n = 8, 32768
    streams = noisy_streams(fixture(resources_dir, "lucky7.expected.cf32"), n_dev, n, 1024, 7)
    outs = time_shard.demod_pipelined(streams, CFG, cpu_mesh(n_dev), clock_backend="scan")
    assert len(outs) == n_dev
    ref = unsharded(streams, n // n_dev, backend="scan")
    jouts = jax_time.demod_pipelined(streams, JCFG, jax_mesh(n_dev, "time"), clock_backend="scan")
    for s in range(n_dev):
        np.testing.assert_array_equal(outs[s], ref[s], err_msg=f"stream {s}")
        within_jax_tolerance(outs[s], jouts[s], f"stream {s}")


@pytest.mark.parametrize("args", [(8, 1 << 20), (4, 1 << 16, 16)])
def test_pipeline_schedule_is_bubble_free(args):
    rep = time_shard.pipeline_schedule_report(args[0], args[1], CFG, *args[2:])
    assert rep == jax_time.pipeline_schedule_report(args[0], args[1], JCFG, *args[2:])
    assert rep["idle_device_rounds"] == 0 and rep["schedule_efficiency"] == 1.0
    assert rep["busy_device_rounds"] == args[0] ** 2
    assert rep["clock_block_tasks"] == rep["streams"] * args[0]
    assert rep["halo_bytes_per_device"] > 0


def test_grid_sharded_channels_by_time(resources_dir):
    """Two channel shards, each a time mesh of four CPU shards: every
    channel equals its stream through the unsharded step, and JAX's grid."""
    iq = fixture(resources_dir, "lucky7.expected.cf32")[:32768]
    channels = 4
    batch = np.tile(iq, (channels, 1))
    outs = time_shard.demod_grid_sharded(batch, CFG, [cpu_mesh(4), cpu_mesh(4)], clock_backend="scan")
    ref = unsharded(iq[None], 8192, backend="scan")[0]
    jmesh = JaxMesh(np.array(jax.devices()[:8]).reshape(2, 4), axis_names=("channel", "time"))
    jouts = jax_time.demod_grid_sharded(batch, JCFG, jmesh, clock_backend="scan")
    for ch in range(channels):
        np.testing.assert_array_equal(outs[ch], ref, err_msg=f"channel {ch}")
        within_jax_tolerance(outs[ch], jouts[ch], f"channel {ch}")
    with pytest.raises(ValueError, match="same size"):
        time_shard.demod_grid_sharded(batch, CFG, [cpu_mesh(4), cpu_mesh(2)])


def test_pipelined_lane_packing_k_streams(resources_dir):
    """S > D: k = ceil(S / D) streams a ring group (10 over 4: k = 3, two
    lanes of zeros), every stream still equal to its solo run."""
    n_dev, n, s_streams = 4, 16384, 10
    streams = noisy_streams(fixture(resources_dir, "lucky7.expected.cf32"), s_streams, n, 512, 3)
    outs = time_shard.demod_pipelined(streams, CFG, cpu_mesh(n_dev), clock_backend="scan")
    assert len(outs) == s_streams
    ref = unsharded(streams, n // n_dev, backend="scan")
    jouts = jax_time.demod_pipelined(streams, JCFG, jax_mesh(n_dev, "time"), clock_backend="scan")
    for s in range(s_streams):
        np.testing.assert_array_equal(outs[s], ref[s], err_msg=f"stream {s}")
        within_jax_tolerance(outs[s], jouts[s], f"stream {s}")


def test_pipelined_clock_kernel_equals_scan(resources_dir):
    """The production clock (``clock_backend="pallas"``, B2's plain version
    here) gives the scan clock's bits on the sharded path."""
    streams = noisy_streams(fixture(resources_dir, "lucky7.expected.cf32"), 6, 16384, 700, 5)
    a = time_shard.demod_pipelined(streams, CFG, cpu_mesh(4), clock_backend="pallas")
    b = time_shard.demod_pipelined(streams, CFG, cpu_mesh(4), clock_backend="scan")
    for s in range(6):
        np.testing.assert_array_equal(a[s], b[s], err_msg=f"stream {s}")


def test_pipelined_doppler_golden(resources_dir):
    """The raw lucky7 capture with its Doppler tables skewed like the data
    demodulates to the golden on four shards; a lane of the pre-corrected
    capture without Doppler rides along.  Both equal the unsharded step fed
    the same tables."""
    n_dev = 4
    raw = fixture(resources_dir, "lucky7.cf32")
    pre = fixture(resources_dir, "lucky7.expected.cf32")
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)
    n = (len(raw) // (n_dev * CFG.decimation)) * n_dev * CFG.decimation
    streams = np.stack([raw[:n], pre[:n]]).astype(np.complex64)
    outs = time_shard.demod_pipelined(streams, CFG, cpu_mesh(n_dev), clock_backend="scan",
                                      dopplers=[Doppler(**ARGS), None])
    ref = unsharded(streams, n // n_dev, dopplers=[Doppler(**ARGS), None], backend="scan")
    jouts = jax_time.demod_pipelined(streams, JCFG, jax_mesh(n_dev, "time"), clock_backend="scan",
                                     dopplers=[JaxDoppler(**ARGS), None])
    for s in range(2):
        np.testing.assert_array_equal(outs[s], ref[s], err_msg=f"stream {s}")
        assert within_golden(outs[s][: len(golden)], golden, f"stream {s}") >= len(golden) - 2
        within_jax_tolerance(outs[s], jouts[s], f"stream {s}")


def test_grid_sharded_doppler(resources_dir):
    """Per-channel Doppler through the grid (2 channel shards x 4 time
    shards): every channel within +-2 LSB of the golden, equal to its
    channel shard's ``demod_pipelined``."""
    raw = fixture(resources_dir, "lucky7.cf32")
    pre = fixture(resources_dir, "lucky7.expected.cf32")
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)
    n = 32768
    batch = np.stack([raw[:n], pre[:n], raw[:n], pre[:n]]).astype(np.complex64)
    outs = time_shard.demod_grid_sharded(batch, CFG, [cpu_mesh(4), cpu_mesh(4)], clock_backend="scan",
                                         dopplers=[Doppler(**ARGS), None, Doppler(**ARGS), None])
    alone = time_shard.demod_pipelined(batch[[0, 2]], CFG, cpu_mesh(4), clock_backend="scan",
                                       dopplers=[Doppler(**ARGS), Doppler(**ARGS)])
    jmesh = JaxMesh(np.array(jax.devices()[:8]).reshape(2, 4), axis_names=("channel", "time"))
    jouts = jax_time.demod_grid_sharded(batch, JCFG, jmesh, clock_backend="scan",
                                        dopplers=[JaxDoppler(**ARGS), None, JaxDoppler(**ARGS), None])
    for ch in range(4):
        assert within_golden(outs[ch], golden, f"channel {ch}") > 3000
        within_jax_tolerance(outs[ch], jouts[ch], f"channel {ch}")
    np.testing.assert_array_equal(outs[0], alone[0])
    np.testing.assert_array_equal(outs[2], alone[1])


def test_time_shard_refuses_blocks_shorter_than_a_history():
    """A shard's block must hold each stage's history (the halo comes from
    one neighbour): the 637-row DC history at 8 shards of 8192 samples
    (512 decimated rows a shard) raises."""
    iq = np.zeros((1, 8192), np.complex64)
    with pytest.raises(ValueError, match="history"):
        time_shard.demod_pipelined(iq, CFG, cpu_mesh(8))


# ---- the arctangent mode on the time shard and the channel class


def _halo_front(streams, n_dev, mode):
    """``demod_pipelined``'s front as its shards compute it, ``_front_halo``
    over the skewed layout, regrouped as each stream's blocks in time order:
    [stream][block] -> y3 (rows,)."""
    x_skew, _, block, k = time_shard._skewed_layout(streams, None, CFG, n_dev)
    lanes = x_skew.shape[2] // 2
    pipe = DemodPipeline(CFG, block, use_atan_lut=mode, device="cpu")
    mesh = cpu_mesh(n_dev)
    shards = [time_shard._Shard(pipe, p, k, lanes) for p in range(n_dev)]
    soft = time_shard._front_halo(mesh, shards, mesh.put(x_skew), None)
    return [[soft[(s // k + dd) % n_dev][:, s] for dd in range(n_dev)] for s in range(len(streams))]


def _banded_front_blocks(streams, block, mode):
    """Each stream through the port's unsharded banded front at ``block``,
    the state carried: [stream][block] -> y3 (rows,)."""
    from sdrmodem_tpu_torch.ops.front import banded_front

    s, n = streams.shape
    pipe = DemodPipeline(CFG, block, use_atan_lut=mode, device="cpu")
    state = pipe.init_full_state(s)[:4]
    out = [[] for _ in range(s)]
    for t in range(n // block):
        part = streams[:, t * block : (t + 1) * block]
        x = torch.from_numpy(np.concatenate([part.real.T, part.imag.T], axis=1).astype(np.float32))
        y3, state = banded_front(x, *state, pipe.front_taps)
        for k in range(s):
            out[k].append(y3[:, k])
    return out


def test_time_shard_front_takes_the_arctangent_mode(resources_dir):
    """``demod_pipelined(use_atan_lut="atan2")``: the halo front on 2 shards
    equals the unsharded banded front in "atan2" bit for bit and is not the
    LUT's; the streams' symbols equal the unsharded "atan2" step's and are
    within JAX's tolerance of JAX's ``demod_pipelined`` in the same mode
    (``jnp.arctan2`` in its ``_front_full_halo``)."""
    n_dev, n = 2, 16384
    streams = noisy_streams(fixture(resources_dir, "lucky7.expected.cf32"), 2, n, 1024, 11)
    halo = _halo_front(streams, n_dev, "atan2")
    alone = _banded_front_blocks(streams, n // n_dev, "atan2")
    lut = _halo_front(streams, n_dev, True)
    for s in range(2):
        for dd in range(n_dev):
            assert torch.equal(halo[s][dd], alone[s][dd]), f"stream {s} block {dd}"
            assert not torch.equal(halo[s][dd], lut[s][dd]), f"stream {s} block {dd}: the LUT's y3"
    outs = time_shard.demod_pipelined(streams, CFG, cpu_mesh(n_dev), clock_backend="scan", use_atan_lut="atan2")
    pipe = DemodPipeline(CFG, n // n_dev, use_atan_lut="atan2", device="cpu")
    step = pipe.make_batched_step_full("scan", layout="tm")
    state = pipe.init_full_state(2)
    ref = [[], []]
    for t in range(n_dev):
        part = streams[:, t * (n // n_dev) : (t + 1) * (n // n_dev)]
        x = torch.from_numpy(np.concatenate([part.real.T, part.imag.T], axis=1).astype(np.float32))
        state, sym, cnt = step(state, x)
        for k in range(2):
            ref[k].append(collect(sym, cnt, k))
    jouts = jax_time.demod_pipelined(streams, JCFG, jax_mesh(n_dev, "time"), clock_backend="scan",
                                     use_atan_lut="atan2")
    for s in range(2):
        np.testing.assert_array_equal(outs[s], np.concatenate(ref[s]), err_msg=f"stream {s}")
        within_jax_tolerance(outs[s], jouts[s], f"stream {s}")
    grid = time_shard.demod_grid_sharded(streams, CFG, [cpu_mesh(n_dev)] * 2, clock_backend="scan",
                                         use_atan_lut="atan2")
    for s in range(2):
        np.testing.assert_array_equal(grid[s], outs[s], err_msg=f"grid channel {s}")


def test_channel_sharded_full_takes_the_arctangent_mode(resources_dir):
    """``ShardedChannelDemodFull(use_atan_lut="atan2")`` runs (the banded
    route a shard) and equals the unsharded "atan2" step bit for bit."""
    iq = fixture(resources_dir, "lucky7.expected.cf32")
    channels, block = 4, 4096
    lanes = np.stack([iq[k * 3000 : k * 3000 + block] for k in range(channels)])
    sharded = ShardedChannelDemodFull(CFG, block, channels, cpu_mesh(2, "channel"), use_atan_lut="atan2")
    _, symbols, counts = sharded.step(sharded.init_state(), sharded.place_input(lanes))
    pipe = DemodPipeline(CFG, block, use_atan_lut="atan2", device="cpu")
    x = torch.from_numpy(np.stack([lanes.real, lanes.imag], axis=1).astype(np.float32))
    _, sym, cnt = pipe.make_batched_step_full()(pipe.init_full_state(channels), x)
    assert torch.equal(symbols, sym) and torch.equal(counts, cnt) and int(cnt.sum()) > 0
