"""BENCHMARK.json against the contract's shape, and every file a cell, a
configuration or a metric names, found by name."""

import json
import os
import re

import pytest

from gan_bench import run

BENCH = run.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gan_bench"]
    assert BENCH["command"][:3] == ["python3", "-m", "gan_bench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
    assert all("mfu" in m["name"] or not m["name"].endswith("roofline") or m["unit"] == "%"
               for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert entry["chips"] == 1
    spec = run.load_json("workloads", cell)
    assert spec["config"] == entry["config"]
    assert {"config", "traffic", "limits"} <= set(spec) <= {"config", "traffic", "limits",
                                                            "kink_margin"}
    for kind in ("builders", "counts", "reference"):
        assert run.module(kind, entry["config"]) is not None
    config = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert os.path.exists(os.path.join(run.ROOT, config["file"]))
    with open(os.path.join(run.ROOT, config["file"])) as f:
        assert json.load(f)["reduced"] == config["reduced"]
    kinds = {"end_to_end", "per_layer"}
    reported = {k: [m["name"] for m in run.cell_metrics(BENCH, cell, k)] for k in kinds}
    assert "setup_s" in reported["end_to_end"] and len(reported["end_to_end"]) >= 2
    assert reported["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(run.module("metrics", metric).read)


def test_limits_are_set_for_every_cell():
    from gan_bench.correct import gaps

    known = set(gaps({"losses": [], "grad": {}, "change": {}},
                     {"losses": [], "grad": {}, "change": {}})[0])
    for w in BENCH["workloads"]:
        limits = run.load_json("workloads", w["name"])["limits"]
        assert limits and set(limits) <= known
        assert all(isinstance(v, float) and v > 0 for v in limits.values())
