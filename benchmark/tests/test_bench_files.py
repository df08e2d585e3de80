"""Each configuration, traffic mix, limit file and per-layer metric is
found by its name, with no edit to the harness."""

import json
import shutil

import pytest

from benchmark import core

BENCHMARK = core.read_json(core.ROOT / "BENCHMARK.json")


@pytest.fixture
def tree(tmp_path):
    """A copy of the benchmark with BENCHMARK.json beside it."""
    shutil.copytree(core.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_every_cell_finds_its_files():
    for w in BENCHMARK["workloads"]:
        cell = core.Cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert core.driver(cell.mix["driver"]).run
        assert cell.limits and all(float(v) > 0 for k, v in cell.limits.items() if not k.startswith("_"))
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(core.metric_reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_new_config_mix_and_metric_are_picked_up(tree):
    bench = tree / "benchmark"
    cfg = core.read_json(bench / "configs" / "lucky7.json")
    cfg["name"] = "lucky7_slow"
    cfg["radio"]["baud_rate"] = 2400
    (bench / "configs" / "lucky7_slow.json").write_text(json.dumps(cfg))
    mix = core.read_json(bench / "traffic" / "fanout128.json")
    mix["lanes"] = 256
    (bench / "traffic" / "fanout256.json").write_text(json.dumps(mix))
    (bench / "limits" / "lucky7_slow.fanout256.json").write_text('{"off2_share": 0.5}')
    (bench / "metrics" / "step.blocks.py").write_text("def read(ctx):\n    return ctx.get('steps')\n")
    spec = core.read_json(tree / "BENCHMARK.json")
    spec["configs"].append({"name": "lucky7_slow", "source": "x", "file": "benchmark/configs/lucky7_slow.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "lucky7_slow.fanout256", "config": "lucky7_slow",
                              "traffic": "fanout256", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "step.blocks", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "x", "moves": "rx_msps",
                              "workloads": ["lucky7_slow.fanout256"]})
    spec["end_to_end"][0]["workloads"].append("lucky7_slow.fanout256")
    (tree / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = core.Cell("lucky7_slow.fanout256", root=tree)
    assert cell.config["radio"]["baud_rate"] == 2400
    assert cell.mix["lanes"] == 256
    assert cell.limits == {"off2_share": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["step.blocks"]
    assert core.metric_reader("step.blocks", cell.bench)({"steps": 7}) == 7
    assert core.driver(cell.mix["driver"], cell.bench).run


def test_metric_readers_find_nothing_outside_their_cells():
    empty = {"summary": {"busy_s": 1.0, "window_s": 2.0, "kernels": {}, "gaps": {}}}
    for m in BENCHMARK["per_layer"]:
        assert core.metric_reader(m["name"])(empty) is None
