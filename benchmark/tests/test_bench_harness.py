"""The harness on the CPU: the manifest's form, files found by name, the
result's keys, the frozen costs, the reference against the port at a small
size, and the runs' imports."""

import json
import math
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark.lib import cell, costs
from benchmark.tests.conftest import ROOT, small_overrides

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def manifest(root=ROOT):
    return json.loads((root / "BENCHMARK.json").read_text())


def test_manifest_names_units_and_files():
    spec = manifest()
    assert list(spec) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    bench = ROOT / "benchmark"
    metrics = spec["end_to_end"] + spec["per_layer"]
    for entry in spec["configs"] + spec["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for w in spec["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
        traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
        assert (bench / "loops" / f"{traffic['loop']}.py").is_file()
        limits = json.loads((bench / "limits" / f"{w['name']}.json").read_text())
        assert limits and all(v > 0 for v in limits.values())
        assert "setup_s" in cell.metrics_of(w, "end_to_end")
        assert len(cell.metrics_of(w, "end_to_end")) >= 2
        assert cell.metrics_of(w, "per_layer")
    for m in spec["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert m["moves"] in cell.metrics_of(
                next(c for c in spec["workloads"] if c["name"] == w), "end_to_end")


def test_frozen_costs_give_the_table_bounds():
    """The bounds of PERF.md's kernel table at its shapes."""
    def ms(name, *shape):
        return round(costs.bound_ms(*costs.COSTS[name](*shape))[0], 4)

    assert ms("cinv", 196611, 4) == 0.0150
    assert ms("neg_ptgpt", 196611, 4) == 0.0225
    assert ms("sos", 96, 11, 65537) == 0.0333
    assert ms("sos_backward", 96, 11, 65537) == 0.0617
    assert ms("lu", 196611, 4) == 0.0197
    assert ms("lut_apply", 196611, 4) == 0.0122
    assert costs.bound_ms(*costs.cinv_cost(196611, 4))[1] == "bytes"


def check_run(name: str, root=ROOT) -> None:
    """A whole run of a cell at a small size: the result's keys in order,
    the numbers compared last, each within the cell's limit."""
    torch.manual_seed(0)
    spec = manifest(root)
    workload = next(w for w in spec["workloads"] if w["name"] == name)
    out = cell.run_cell(name, 2 ** 31 + 77, 1.0, False, "cpu", time.perf_counter(), root=root,
                        overrides=small_overrides(workload["config"]))
    assert list(out) == RESULT_KEYS + ["checks"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == set(cell.metrics_of(workload, "end_to_end", root))
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("name", ["fullband-train", "three-room-train"])
def test_cell_runs_and_agrees_with_the_reference_on_cpu(name):
    check_run(name)


def test_a_cell_config_mix_and_metric_are_added_as_files(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric and a cell by new files and manifest entries only."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = manifest()
    bench = tmp_path / "benchmark"
    conf = json.loads((bench / "configs" / "three_room_example.json").read_text())
    conf.update(name="three_room_small_heads", **small_overrides("three_room_example"))
    conf["preset"]["output_filter_config"]["num_neurons_per_layer"] = 32
    (bench / "configs" / "three_room_small_heads.json").write_text(json.dumps(conf))
    (bench / "traffic" / "grid_train_short.json").write_text(json.dumps(
        {"loop": "grid_train", "trace_units": 1}))
    (bench / "metrics" / "train.epochs.py").write_text(
        "def read(run, trace, units):\n    return float(len(units))\n")
    (bench / "limits" / "small-heads-train.json").write_text(
        (bench / "limits" / "three-room-train.json").read_text())
    spec["configs"].append({"name": "three_room_small_heads", "source": "a test",
                            "file": "benchmark/configs/three_room_small_heads.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "small-heads-train", "config": "three_room_small_heads",
                              "traffic": "grid_train_short", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "train_rirs_per_s" in (m["name"], m.get("moves")):
            m["workloads"].append("small-heads-train")
    spec["per_layer"].append({"name": "train.epochs", "unit": "epochs", "better": "higher",
                              "source": "host_clock", "layer": "Trainer and step graphs",
                              "moves": "train_rirs_per_s", "workloads": ["small-heads-train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    out = cell.run_cell("small-heads-train", 5, 0.5, False, "cpu", time.perf_counter(),
                        root=tmp_path)
    assert out["correct"] is True and "train_rirs_per_s" in out["metrics"]
    run, loop = cell.prepare("small-heads-train", 5, "cpu", root=tmp_path)
    assert run.preset["output_filter_config"]["num_neurons_per_layer"] == 32
    read = cell.per_layer(run, ["train.epochs"], None, [{}, {}], root=tmp_path)
    assert read == {"train.epochs": {"value": 2.0, "unit": "epochs"}}


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.gfdn; "
            "import benchmark.lib.checks; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('diffgfdn_torch', 'diffgfdn_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)") % str(ROOT)
    assert subprocess.run([sys.executable, "-c", code], capture_output=True).returncode == 0


def test_a_run_loads_no_jax_module():
    """A whole cell run on the CPU, then the run's own look at sys.modules."""
    code = ("import sys, time; sys.path.insert(0, %r); "
            "from benchmark.tests.conftest import small_overrides; "
            "from benchmark.lib import cell; import benchmark.run as r; "
            "cell.run_cell('three-room-train', 3, 0.2, False, 'cpu', time.perf_counter(), "
            "overrides=small_overrides('three_room_example')); "
            "print(r.forbidden_modules()); sys.exit(1 if r.forbidden_modules() else 0)"
            ) % str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert p.returncode == 0, p.stdout + p.stderr


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import benchmark.run as r

    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert "jaxlib.fake" in r.forbidden_modules()
    assert "jaxtyping_like" not in r.forbidden_modules()


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                        "fullband-train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
