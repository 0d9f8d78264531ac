"""A configuration's tracking reference is a file of its own: the check
imports ``reference/<name>.py`` by the name the configuration gives.

A copy of the benchmark with a reference module added as a new file and
named in a configuration is checked with that module, in single blocks
and in spans, with no file of the harness edited; the lookup of
``scanned`` and ``fused`` gives what the direct calls give on seeded
inputs; an unknown name raises naming the missing file; and
``carrier_truth_hz`` reads a block's carriers against the sky."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench.harness import checks, spec
from gpubench.reference import fused, ledger, scanned, span
from gpubench.signals import SIGNALS

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"

PROBE = '''"""fused's arithmetic, counting its calls."""
from . import fused
from .fused import N_FIELDS, build_replicas, fma, rounding  # noqa: F401

CALLS = {"run": 0, "superstep": 0}


class Tracker(fused.Tracker):
    def run(self, *a, **kw):
        CALLS["run"] += 1
        return super().run(*a, **kw)


def superstep(*a, **kw):
    CALLS["superstep"] += 1
    return fused.superstep(*a, **kw)
'''

DRIVE = """
import json, sys
from gpubench.harness import checks, spec
from gpubench.harness.cell import run_cell
from gpubench.reference import fused_probe
out = {}
for cell in ("gps4.probe_blocks", "gps4.probe_spans"):
    before = dict(fused_probe.CALLS)
    run = run_cell(spec.load_benchmark(), cell, 1234567, 1.5, False,
                   device="cpu", log=lambda m: None)
    ok, numbers = checks.check(run, log=lambda m: None)
    out[cell] = dict(ok=ok, numbers={k: v for k, (v, _) in numbers.items()},
                     calls={k: fused_probe.CALLS[k] - before[k]
                            for k in before})
json.dump(out, open("probe.json", "w"))
"""


def test_reference_module_added_as_a_file(tmp_path):
    """A new ``reference/fused_probe.py`` named by a new configuration
    runs in single blocks (its ``Tracker.run``) and in spans (its
    ``superstep``); the harness's files and the reference modules that
    were there stay as they are."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "gpubench/reference/fused_probe.py").write_text(PROBE)
    cfg = json.loads((DATA / "gps4_spans.json").read_text())
    cfg["name"] = "gps4_probe"
    cfg["reference"]["tracker"] = "fused_probe"
    (tmp_path / "gpubench/configs/gps4_probe.json").write_text(
        json.dumps(cfg))
    spans = json.loads((DATA / "spans2.json").read_text())
    blocks = json.loads((DATA / "spans2.json").read_text())
    del blocks["drive"]
    blocks["check"] = {"track_blocks": 4, "acq_searches": 4,
                       "nav_min_s": 1000.0}
    for name, t in (("probe_spans", spans), ("probe_blocks", blocks)):
        (tmp_path / f"gpubench/traffic/{name}.json").write_text(
            json.dumps(t))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "gps4_probe", "source": "gpubench/tests/data",
        "file": "gpubench/configs/gps4_probe.json", "reduced": [],
        "why": "a test configuration"})
    bench["workloads"] += [
        {"name": f"gps4.{t}", "config": "gps4_probe", "traffic": t,
         "chips": 1, "why": "a test cell"}
        for t in ("probe_blocks", "probe_spans")]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path, env=env,
                   check=True, timeout=900, capture_output=True)
    out = json.loads((tmp_path / "probe.json").read_text())
    blocks, spans = out["gps4.probe_blocks"], out["gps4.probe_spans"]
    assert blocks["ok"] and spans["ok"], out
    assert blocks["calls"]["run"] >= 4, out
    assert spans["calls"]["superstep"] > 0 and spans["calls"]["run"] == 0
    for sub in ("harness", "reference"):
        for f in (ROOT / "gpubench" / sub).glob("*.py"):
            assert (tmp_path / "gpubench" / sub / f.name).read_bytes() == \
                f.read_bytes(), f


def test_unknown_reference_names_its_file():
    with pytest.raises(FileNotFoundError, match=r"reference/nowhere\.py"):
        spec.reference("nowhere")
    with pytest.raises(FileNotFoundError):
        spec.reference("../harness/checks")


def _branch(config: str) -> tuple[dict, dict]:
    """(stream, GPS branch) of a configuration of the benchmark's or of
    the tests' data."""
    if (DATA / f"{config}.json").exists():
        cfg = spec.load_json(DATA / f"{config}.json")
    else:
        cfg = spec.load_config(spec.load_benchmark(), config)
    return cfg["stream"], cfg["branches"]["gps_l1ca"]


def _inputs(d: dict, fs: float, seed: int):
    """A seeded window (noise and a satellite) and a ledger of three
    channels started at seeded offsets and carriers."""
    lay = checks.Layout(d, fs, 1)
    rng = np.random.default_rng(seed)
    n = lay.history + lay.block
    sig = SIGNALS["gps_l1ca"]
    code = np.tile(sig.sample_code(5, fs), n // lay.n0 + 2)
    lag, dop = int(rng.integers(0, lay.n0)), float(rng.uniform(-3e3, 3e3))
    t = np.arange(n) / fs
    x = 0.5 * code[lag:lag + n] * np.exp(2j * np.pi * dop * t)
    x = x + (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.7
    re = torch.from_numpy(x.real.astype(np.float32))
    im = torch.from_numpy(x.imag.astype(np.float32))
    c = d["track"]["n_channels"]
    empty = {f: np.zeros(c, dt) for f, dt in ledger.DTYPES.items()}
    empty["prn_idx"][:] = -1
    events = [(5, dop, (lay.n0 - lag) % lay.n0 + lay.n0),
              (9, float(rng.uniform(-3e3, 3e3)), int(rng.integers(0, 999))),
              (17, float(rng.uniform(-3e3, 3e3)), int(rng.integers(0, 999)))]
    st = ledger.handoff(empty, events, sig.code_rate_hz)
    return lay, st, re, im


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k]),
                              equal_nan=True), k


@pytest.mark.parametrize("seed", [11, 12])
def test_scanned_lookup_equals_direct_call(seed):
    stream, d = _branch("gps_l1_rtlsdr")
    fs = float(stream["fs_hz"])
    lay, st, re, im = _inputs(d, fs, seed)
    sig = SIGNALS["gps_l1ca"]
    mod = spec.reference("scanned")
    assert mod is scanned
    trk = mod.Tracker(sig, d, fs, lay)
    p = scanned.params(d["track"], fs, sig.code_length, sig.code_rate_hz,
                       sig.code_period_ms)
    table = torch.from_numpy(np.stack(
        [sig.table(q) for q in range(1, d["acq"]["n_prn"] + 1)]).astype(
            np.float32))
    codes = table[np.maximum(st["prn_idx"], 0)]
    for control, dtype in ((False, torch.float32), (True, torch.bfloat16)):
        direct = scanned.track_block(p, codes, st, re, im, lay.epochs + 1,
                                     lay.history + lay.block, dtype=dtype)
        _equal(trk.run(st, re, im, control), direct)


@pytest.mark.parametrize("seed", [21, 22])
def test_fused_lookup_equals_direct_call(seed):
    stream, d = _branch("gps4_spans")
    fs = float(stream["fs_hz"])
    lay, st, re, im = _inputs(d, fs, seed)
    sig = SIGNALS["gps_l1ca"]
    mod = spec.reference("fused")
    assert mod is fused
    trk = mod.Tracker(sig, d, fs, lay)
    g = fused.Geometry.create(
        d, fs, sig.code_length, sig.code_rate_hz, sig.carrier_hz,
        sig.code_period_ms, sig.boc, lay.history + lay.block)
    table = fused.sampled_table(
        lambda q: sig.sample_code(q, fs), d["acq"]["n_prn"], lay.n0,
        lay.n0 + d["track"]["window_margin"])
    assert g == trk.g and torch.equal(table, trk.table)
    prog = fused.track_block(g, table, st, re, im, fs)
    _equal(trk.run(st, re, im, False), prog)
    _equal(trk.run(st, re, im, True),
           fused.track_block(g, table, st, re, im, fs, rnd=fused.f8))
    _equal(trk.run(st, re, im, False, follow=prog),
           fused.track_block(g, table, st, re, im, fs, follow=prog))
    # the span scan's first block over the same window
    led = span.led_from_state(st, sig.code_rate_hz)
    one = span.track_block(mod, g, trk.table, led, st["prn_idx"], 0, re,
                           im, fs, lay.block, int(sig.code_length))
    two = span.track_block(fused, g, table, led, st["prn_idx"], 0, re, im,
                           fs, lay.block, int(sig.code_length),
                           rnd=fused.bf16)
    _equal(one[0], two[0])
    for x, y in zip(one[1], two[1]):
        assert np.array_equal(x, y)


def test_carrier_truth_reads_each_tracked_channel():
    """A channel's mean carrier over the epochs it processed against its
    satellite's; too short a track, an unprocessed channel and a PRN not
    in the sky are left out."""
    t, c = 6, 5
    proc = np.ones((t, c), bool)
    proc[-1, 1] = False            # channel 1 processed epochs 0-4
    proc[:, 4] = False             # channel 4 processed nothing
    freq = np.full((t, c), 1000.0, np.float32)
    freq[:5, 1] = 1030.0
    freq[-1, 1] = 5000.0           # not processed: not read
    freq[-1, 3] = 7000.0           # one epoch in six: 1000 Hz on the mean
    epochs = np.tile(np.arange(t)[:, None] + 3000, (1, c))
    epochs[:, 2] = np.arange(t) + 100          # tracked 0.1 s
    prog = dict(processed=proc, carr_freq=freq, epoch_index=epochs)
    prn_idx = np.array([0, 1, 2, 3, 4])
    truth = {1: 1004.0, 2: 1000.0, 3: 1500.0, 5: 0.0}   # PRN 4 not in view
    hz, prn = checks.truth_gap(prog, prn_idx, truth, 1e-3, 2.0)
    assert (hz, prn) == (30.0, 2)
    hz, prn = checks.truth_gap(prog, prn_idx, truth, 1e-3, 0.05)
    assert (hz, prn) == (500.0, 3)
