"""A cell, a traffic mix and a per-layer metric added as files alone: a
copy of the benchmark with a new traffic file, a new metric file and
their entries in BENCHMARK.json runs the new cell on the CPU and reports
the new metric (and a new member of a family of metrics through the
family's reader), with no file of the harness edited."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

DRIVE = """
import json, sys, time
from gpubench.harness import spec, entry
r = entry.execute(spec.load_benchmark(), "rtlsdr.three_sats", 5, 0.5, True,
                  device="cpu", out=open("result.json", "w"))
"""


def test_new_cell_metric_and_traffic_from_files(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((ROOT / "gpubench/traffic/open_sky.json").read_text())
    traffic["satellites"][0]["prns"] = [4, 17, 25]
    traffic["trace"] = {"start_block": 0, "blocks": 2}
    (tmp_path / "gpubench/traffic/three_sats.json").write_text(
        json.dumps(traffic))
    (tmp_path / "gpubench/metrics/blocks_seen.test.py").write_text(
        "def read(run):\n    return float(run.window_blocks)\n")
    bench["workloads"].append({
        "name": "rtlsdr.three_sats", "config": "gps_l1_rtlsdr",
        "traffic": "three_sats", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "rtlsdr.open_sky" in m.get("workloads", []):
            m["workloads"].append("rtlsdr.three_sats")
    bench["per_layer"].append({
        "name": "blocks_seen.test", "unit": "blocks", "better": "higher",
        "source": "host_clock", "layer": "receiver pipeline",
        "moves": "card_ms_per_s.rtlsdr", "workloads": ["rtlsdr.three_sats"]})
    # a new member of a family of metrics takes the family's reader
    bench["per_layer"].append({
        "name": "nav_ms_per_s.test", "unit": "ms/signal_s",
        "better": "lower", "source": "program_span", "layer": "nav",
        "moves": "card_ms_per_s.rtlsdr", "workloads": ["rtlsdr.three_sats"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path, env=env,
                   check=True, timeout=600, capture_output=True)
    result = json.loads((tmp_path / "result.json").read_text())
    assert result["metrics"]["blocks_seen.test"]["value"] >= 1
    assert result["metrics"]["nav_ms_per_s.test"]["value"] > 0
    assert "track_ms_per_s.rtlsdr" not in result["metrics"]
    for f in (ROOT / "gpubench/harness").glob("*.py"):
        assert (tmp_path / "gpubench/harness" / f.name).read_bytes() == \
            f.read_bytes()
