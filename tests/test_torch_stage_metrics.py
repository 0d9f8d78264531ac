"""The benchmark's readers of the receiver's sub-stages
(``gpubench/metrics/{track_anchor,track_launch,track_wait,track_absorb,
nav_sync,window,lifecycle}_ms_per_s.py``): a copy of the benchmark runs
the CPU ``rtlsdr.open_sky`` cell traced, in the manner of
gpubench/tests/test_gpubench_new_files.py, and reports each new rtlsdr
metric; against a program without those stages each reader returns None,
so the line leaves the metric out."""
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
STAGES = {"track_anchor_ms_per_s": "track.anchor",
          "track_launch_ms_per_s": "track.launch",
          "track_wait_ms_per_s": "track.wait",
          "track_absorb_ms_per_s": "track.absorb",
          "nav_sync_ms_per_s": "nav.sync",
          "window_ms_per_s": "window",
          "lifecycle_ms_per_s": "lifecycle"}
NEW_RTLSDR = [f"{b}.rtlsdr" for b in STAGES if b != "track_anchor_ms_per_s"]

DRIVE = """
from gpubench.harness import spec, entry
entry.execute(spec.load_benchmark(), "rtlsdr.open_sky", 4500000011, 0.5,
              True, device="cpu", out=open("result.json", "w"))
"""


def _reader(base):
    sys.path.insert(0, str(ROOT))
    try:
        from gpubench.harness import spec
        return spec.metric_reader(f"{base}.x")
    finally:
        sys.path.remove(str(ROOT))


def _run(stages: dict):
    br = types.SimpleNamespace(
        stages1=stages, stage_s=lambda name: stages.get(name, 0.0))
    return types.SimpleNamespace(branches={"gps_l1ca": br}, signal_s=2.0)


@pytest.mark.parametrize("base", sorted(STAGES))
def test_reader_reads_its_stage_and_none_without_it(base):
    read = _reader(base)
    parent = {"ingest": 0.1, "acquire": 0.2, "track": 0.3, "nav": 0.4}
    assert read(_run(parent)) is None
    assert read(_run({**parent, STAGES[base]: 0.004})) == \
        pytest.approx(2.0)


def test_cpu_rtlsdr_cell_reports_the_new_metrics(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    # the traced stretch from the window's first block, so that a short
    # window holds it
    traffic = json.loads((ROOT / "gpubench/traffic/open_sky.json")
                         .read_text())
    traffic["trace"] = {"start_block": 0, "blocks": 2}
    (tmp_path / "gpubench/traffic/open_sky.json").write_text(
        json.dumps(traffic))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench["per_layer"]
              if "rtlsdr.open_sky" in m.get("workloads", [])}
    assert set(NEW_RTLSDR) <= listed
    assert "track_anchor_ms_per_s.ladder4" in {
        m["name"] for m in bench["per_layer"]}
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}",
               OMP_NUM_THREADS="2")
    subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path, env=env,
                   check=True, timeout=600, capture_output=True)
    result = json.loads((tmp_path / "result.json").read_text())
    assert result["correct"]
    got = result["metrics"]
    for name in NEW_RTLSDR:
        assert name in got, name
        assert got[name]["value"] >= 0 and got[name]["unit"] == \
            "ms/signal_s"
    # the scanned tracker has no re-anchor: the ladder-4 metric is not
    # this cell's
    assert "track_anchor_ms_per_s.ladder4" not in got
    # the idle stretches of the traced stretch are named by sub-step
    gaps = [k for k, _ in result["breakdown"]["idle_gaps"]]
    assert gaps and "stage.gps_l1ca.track" not in gaps
