"""One time mesh across processes (``sdrmodem_tpu_torch/tools/multihost.py``)
on the CPU: two worker processes of two CPU shards each, joined with
``torch.distributed`` over gloo on a free local port, run
``demod_pipelined`` with every halo and clock-state hop between shards 1
and 2 (and 3 and 0) crossing the process boundary.

Tolerance: none.  The symbols across processes equal the one-process run
bit for bit (0 mismatches, the JAX tool's record: ``MULTIHOST.json``), and
the one-process run equals each stream through the unsharded step
(``tests/test_torch_parallel.py``).  Each run is bounded by a timeout and
every process it starts is stopped, so a hang fails the test.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np

from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.parallel.mesh import Mesh
from sdrmodem_tpu_torch.parallel.time_shard import demod_pipelined
from sdrmodem_tpu_torch.tools import multihost

REPO = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--device", "cpu", "--procs", "2", "--shards", "2", "--streams", "4", "--samples", "16384",
        "--timeout", "100"]


def tool(args, tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}  # torch on one thread a process, as in the other tests
    return subprocess.run([sys.executable, "-m", "sdrmodem_tpu_torch.tools.multihost", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


def test_two_processes_equal_one(tmp_path):
    out = tmp_path / "multihost.json"
    run = tool([*ARGS, "--out", str(out)], tmp_path)
    assert run.returncode == 0, run.stderr[-3000:]
    record = json.loads(out.read_text())
    assert json.loads(run.stdout) == record
    jax_keys = set(json.loads((REPO / "MULTIHOST.json").read_text()))
    assert jax_keys <= set(record)
    assert record["ok"] and record["mismatched_symbols"] == 0
    assert record["max_lsb_diff_vs_single_process"] == 0
    assert record["backend"] == "gloo" and "gloo" in record["mechanism"]
    assert record["cross_process"]["processes"] == 2 and record["cross_process"]["devices"] == 4
    assert record["single_process"]["processes"] == 1 and record["single_process"]["devices"] == 4
    # every symbol of every stream compared: the one-process run's count
    ref = demod_pipelined(multihost.make_streams(4, 16384), FskDemodConfig(*multihost.LUCKY7),
                          Mesh(["cpu"] * 4))
    assert record["symbols_compared"] == sum(len(r) for r in ref) > 4 * 1500


def test_a_failing_worker_fails_the_run(tmp_path):
    """NCCL cannot run on CPU shards: the workers fail, the tool exits
    non-zero within its timeout and prints no record."""
    run = tool([*ARGS[:-2], "--timeout", "60", "--backend", "nccl"], tmp_path)
    assert run.returncode != 0
    assert "worker exit codes" in run.stderr
    assert not run.stdout.strip().startswith("{")


def test_streams_are_the_jax_tools():
    """The tool's streams are the JAX tool's (``tools/multihost.py:_streams``):
    the corrected capture at offsets 777 apart, noise from seed 42."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_multihost_tool", REPO / "tools" / "multihost.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    np.testing.assert_array_equal(multihost.make_streams(16, 32768), mod._streams(16, 32768))
