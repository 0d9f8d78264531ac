"""BENCHMARK.json against the benchmark's rules: names and units of the
allowed characters, every named file there, every cell reporting
setup_s, another end-to-end metric and a per-layer metric, every
per-layer metric moving an end-to-end metric its cells report."""
import json
import re

from gpubench.harness import spec

BENCH = spec.load_benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"] == ["python3", "gpubench/run.py"]


def test_names_and_units():
    assert spec.check_names(BENCH) == []
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert re.fullmatch(r"[A-Za-z0-9_/%.\-]{1,16}", m["unit"])
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_files_exist_and_read():
    for c in BENCH["configs"]:
        cfg = spec.load_config(BENCH, c["name"])
        assert cfg["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        spec.load_traffic(w["traffic"])
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert callable(spec.metric_reader(m["name"]))


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        mine = [m["name"] for m in spec.metrics_for(BENCH, w["name"],
                                                    "end_to_end")]
        assert "setup_s" in mine and len(mine) >= 2
        layers = spec.metrics_for(BENCH, w["name"], "per_layer")
        assert layers
        for m in layers:
            assert m["moves"] in mine, (w["name"], m["name"])
            assert m["moves"] in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert set(m.get("workloads", cells)) <= cells


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)
