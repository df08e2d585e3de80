"""The PyTorch port's package boundary and its copies of backend-free code.

- ``import sdrmodem_tpu_torch`` pulls in neither JAX nor ``sdrmodem_tpu``
  (``sdrmodem_tpu/__init__.py`` switches JAX to x64 for every importer);
- the port's copies of the tap design, the MMSE bank and the arctangent
  table are bit-equal to the JAX package's (tolerance: none — the same
  numpy code on the same inputs);
- the JAX <-> port state conversion round-trips exactly, and without a
  device it goes to the card or raises;
- a kernel library's file name changes with its compiler flags and with
  the text of its source and of every shared header.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from sdrmodem_tpu.dsp import taps as jtaps
from sdrmodem_tpu.dsp.elementwise import dc_blocker_taps as j_dc_taps
from sdrmodem_tpu.dsp.fsk_demod import FskDemodConfig as JaxConfig
from sdrmodem_tpu.dsp.pipeline import DemodPipeline as JaxPipeline
from sdrmodem_tpu_torch.dsp import taps as ttaps
from sdrmodem_tpu_torch.ops import _build
from sdrmodem_tpu_torch.dsp.clock_recovery import suffix_cap_for
from sdrmodem_tpu_torch.dsp.elementwise import dc_blocker_taps as t_dc_taps
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.utils.convert import (
    doppler_tables_from_numpy,
    full_state_from_numpy,
    full_state_to_numpy,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "sdrmodem_tpu_torch"

CONFIGS = {
    "lucky7": (48000, 4800, 5000, 2, 2000, True),
    "lucky7_nodc": (48000, 4800, 5000, 2, 2000, False),
    "nusat": (192000, 40000, 5000, 1, 2000, True),
    "nan": (240000, 9600, 5000, 1, 2000, True),
}


def test_import_pulls_in_no_jax():
    code = (
        "import sys, sdrmodem_tpu_torch\n"
        "from sdrmodem_tpu_torch.dsp import pipeline\n"
        "from sdrmodem_tpu_torch.utils import convert, parity\n"
        "from sdrmodem_tpu_torch.dsp import doppler, elementwise, fir, gfsk_mod, nco_host, streaming\n"
        "from sdrmodem_tpu_torch.dsp import clock_recovery, fsk_demod\n"
        "from sdrmodem_tpu_torch.ops import fir, front, clock, tx\n"
        "from sdrmodem_tpu_torch import FskDemodulator\n"
        "from sdrmodem_tpu_torch.orbit import observer, sdp4, sgp4, solar, timeutil, tle\n"
        "from sdrmodem_tpu_torch.server import config, session, tcp_server, wire\n"
        "from sdrmodem_tpu_torch.devices import base, file_source, iio_lib, native_ingest\n"
        "from sdrmodem_tpu_torch.devices import plutosdr, sdr_server_client\n"
        "from sdrmodem_tpu_torch.utils import native, queue\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'sdrmodem_tpu.'))"
        " or m == 'sdrmodem_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_sources_import_nothing_of_the_jax_package():
    sources = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    names = {p.relative_to(REPO).as_posix() for p in sources}
    for want in ("sdrmodem_tpu_torch/orbit/sgp4.py", "sdrmodem_tpu_torch/dsp/doppler.py",
                 "sdrmodem_tpu_torch/ops/fir.py", "sdrmodem_tpu_torch/dsp/gfsk_mod.py",
                 "sdrmodem_tpu_torch/dsp/streaming.py", "sdrmodem_tpu_torch/dsp/nco_host.py",
                 "sdrmodem_tpu_torch/ops/tx.py", "sdrmodem_tpu_torch/dsp/fsk_demod.py",
                 "sdrmodem_tpu_torch/dsp/clock_recovery.py", "sdrmodem_tpu_torch/dsp/pipeline.py",
                 "sdrmodem_tpu_torch/server/tcp_server.py", "sdrmodem_tpu_torch/server/session.py",
                 "sdrmodem_tpu_torch/devices/plutosdr.py", "sdrmodem_tpu_torch/utils/native.py"):
        assert want in names
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "sdrmodem_tpu"), f"{path}: imports {name}"


@pytest.mark.parametrize("name", list(CONFIGS))
def test_taps_bit_equal(name):
    jc, tc = JaxConfig(*CONFIGS[name]), FskDemodConfig(*CONFIGS[name])
    assert np.array_equal(jc.lpf1_taps(), tc.lpf1_taps())
    assert np.array_equal(jc.lpf2_taps(), tc.lpf2_taps())
    assert np.array_equal(j_dc_taps(jc.dc_length), t_dc_taps(tc.dc_length))
    assert (jc.quad_gain, jc.sps, jc.dc_length) == (tc.quad_gain, tc.sps, tc.dc_length)
    assert jc.clock_params() == tc.clock_params()


def test_tables_bit_equal():
    assert ttaps.mmse_interp_taps().shape == (129, 8)
    assert ttaps.atan_table().shape == (257,)
    assert np.array_equal(jtaps.mmse_interp_taps(), ttaps.mmse_interp_taps())
    assert np.array_equal(jtaps.atan_table(), ttaps.atan_table())


@pytest.mark.parametrize("name", ["lucky7", "lucky7_nodc"])
def test_state_conversion_round_trip(name):
    """A JAX initial state (lanes padded to 128) carries into the port's
    unpadded layout and back unchanged."""
    c = 3
    jstate = JaxPipeline(JaxConfig(*CONFIGS[name]), 4096, exact=False).init_full_state(c)
    rng = np.random.default_rng(1)

    def fill(a):  # distinct values, so a lane mix-up shows
        a = np.asarray(a)
        if a.dtype == np.int32:
            return rng.integers(-3, 60, a.shape).astype(np.int32)
        return rng.standard_normal(a.shape).astype(np.float32)

    jstate = type(jstate)(
        *(None if f is None else fill(f) for f in jstate[:4]),
        type(jstate.clock)(*(fill(f) for f in jstate.clock)),
    )
    pipe = DemodPipeline(FskDemodConfig(*CONFIGS[name]), 4096, device="cpu")
    tstate = full_state_from_numpy(jstate, c, device="cpu")
    ref = pipe.init_full_state(c)
    for got, want in zip(tstate[:4], ref[:4]):
        assert (got is None) == (want is None)
        assert got is None or got.shape == want.shape
    assert tstate.clock.suffix.shape == (suffix_cap_for(pipe.config.sps), c)
    back = full_state_to_numpy(tstate)
    cp = 128
    for a, b in zip(back[:4], jstate[:4]):
        if b is None:
            assert a is None
            continue
        if a.shape[1] == 2 * cp:
            cols = list(range(c)) + list(range(cp, cp + c))
        else:
            cols = list(range(c))
        assert np.array_equal(a[:, cols], b[:, cols])
    for a, b in zip(back.clock, jstate.clock):
        assert a.shape == b.shape
        assert np.array_equal(a[..., :c], b[..., :c])


def test_library_name_follows_compiler_flags(monkeypatch):
    """A library built with other flags is never loaded: without the
    clock's -fmad=false its f32 step could be contracted into FMAs."""
    clock, front = _build.library_path("clock"), _build.library_path("front")
    assert clock.parent == front.parent == REPO / "build" / "kernels"
    assert clock != front and clock.name.startswith("libclock-")
    monkeypatch.setitem(_build.EXTRA_FLAGS, "clock", [])
    assert _build.library_path("clock") != clock
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    assert _build.library_path("front") != front


def test_load_builds_once_from_many_threads(monkeypatch):
    """Threads whose first kernel call loads the same library (server
    clients' first blocks on a cold build directory) build it once: the
    others wait for the first and take its library.  More threads than
    cores, and a short switch interval, so a check-then-build race would
    show."""
    import os
    import sys
    import threading
    import time
    import types

    calls = []

    def slow_build(names=None):
        calls.append(list(names))
        time.sleep(0.2)  # nvcc's time, during which the other threads arrive
        return {}

    class FakeLib:
        def __getattr__(self, fn):
            f = types.SimpleNamespace()
            setattr(self, fn, f)
            return f

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(_build, "_libs", {})
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.load("clock", {"f": []})))
               for _ in range(2 * (os.cpu_count() or 4))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert calls == [["clock"]]
    assert len(got) == len(threads) and all(lib is got[0] for lib in got)
    assert got[0].f.argtypes == []


def test_full_state_from_numpy_defaults_to_cuda():
    """Without a device the state goes to the card; with no card it raises
    rather than carrying on on the CPU."""
    jstate = JaxPipeline(JaxConfig(*CONFIGS["lucky7"]), 4096, exact=False).init_full_state(2)
    jstate = jax.tree.map(np.asarray, jstate)
    if torch.cuda.is_available():
        assert full_state_from_numpy(jstate, 2).lpf1_hist.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            full_state_from_numpy(jstate, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            doppler_tables_from_numpy([np.zeros((1, 128), np.float32)] * 4, 2)


def test_library_name_follows_sources(tmp_path, monkeypatch):
    """A change of a kernel's source or of any shared header under csrc/
    names a new library, so a stale build is never loaded (no nvcc
    needed: only the names are computed)."""
    for name, text in (("a.cu", "// a"), ("b.cu", "// b"), ("shared.cuh", "// v1")):
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    a, b = _build.library_path("a"), _build.library_path("b")
    assert a != b and a.name.startswith("liba-")
    (tmp_path / "shared.cuh").write_text("// v2")
    a2, b2 = _build.library_path("a"), _build.library_path("b")
    assert a2 != a and b2 != b
    (tmp_path / "a.cu").write_text("// a, edited")
    assert _build.library_path("a") not in (a, a2)
    assert _build.library_path("b") == b2
    (tmp_path / "extra.cuh").write_text("// new header")
    assert _build.library_path("b") != b2


@pytest.mark.parametrize("channels", [None, 3])
def test_ragged_state_conversion_round_trip(channels):
    """The JAX streamer's DemodState, single or batched (leaves led by C),
    carries into the port and back unchanged, with the tail capacity of
    ``tail_cap_for(omega)``."""
    from sdrmodem_tpu_torch.dsp.clock_recovery import tail_cap_for
    from sdrmodem_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

    cfg = CONFIGS["nan"]  # sps 25: a tail capacity above the floor
    jstate = jax.tree.map(np.asarray, JaxPipeline(JaxConfig(*cfg), 4096, exact=True).init_state())
    if channels is not None:
        rng = np.random.default_rng(channels)
        jstate = jax.tree.map(
            lambda a: (rng.integers(-9, 40, (channels,) + a.shape).astype(a.dtype) if a.dtype == np.int32
                       else rng.standard_normal((channels,) + a.shape).astype(a.dtype)), jstate)
    state = state_from_numpy(jstate, device="cpu")
    ref = DemodPipeline(FskDemodConfig(*cfg), 4096, device="cpu").init_state(channels)
    for got, want in zip(jax.tree.leaves(state), jax.tree.leaves(ref)):
        assert got.shape == want.shape and got.dtype == want.dtype
    assert state.clock.tail.shape[-1] == tail_cap_for(FskDemodConfig(*cfg).sps) > 32
    for a, b in zip(jax.tree.leaves(state_to_numpy(state)), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
