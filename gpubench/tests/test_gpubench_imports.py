"""A run loads neither JAX nor the JAX package (top-level names compared
whole: gnss_sdr_tpu_torch is not gnss_sdr_tpu); run.py exits without a
result where there is no card, and where the port is not beside it."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench.harness.entry import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]

DRY = """
import io, sys
sys.path.insert(0, {root!r})
from gpubench.harness import spec, entry
entry.execute(spec.load_benchmark(), "rtlsdr.open_sky", 3, 0.3, False,
              device="cpu", out=io.StringIO(), err=io.StringIO())
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gnss_sdr_tpu_torch_x", object())
    assert "gnss_sdr_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert "jaxlib" in forbidden_modules()


def test_a_dry_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", DRY.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         check=True, cwd=ROOT)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "gnss_sdr_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "gnss_sdr_tpu"}


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "rtlsdr.open_sky",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_run_py_needs_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run_py(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_py_needs_the_port(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run_py(tmp_path, env)
    assert r.returncode != 0 and r.stdout.strip() == ""
