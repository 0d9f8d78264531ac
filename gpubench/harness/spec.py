"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, and
the files it names by convention under ``gpubench/``:

  configs/<config>.json     the configuration as it is run
  traffic/<traffic>.json    a traffic mix (a sky and how a run drives it)
  metrics/<metric>.py       a reader: ``read(run)`` -> number or None
                            (or ``metrics/<base>.py`` for ``<base>.<x>``)
  rooflines/<kernel>.py     a kernel's bytes and operations per launch
  reference/<name>.py       a configuration's tracking reference, named
                            by its ``reference.tracker``

A new configuration, traffic mix, metric or kernel is a new file and an
entry in ``BENCHMARK.json``; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MODULE_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    return load_json(Path(root) / config_entry(bench, name)["file"])


def load_traffic(traffic: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(Path(bench_dir) / "traffic" / f"{traffic}.json")


def metrics_for(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    whose ``workloads`` list it, or that have no such list."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def load_module(path):
    """A module from a file path (metric and roofline files have dots in
    their names, so they are not importable by name)."""
    path = Path(path)
    spec = importlib.util.spec_from_file_location(
        "gpubench_" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    """``metrics/<name>.py``, or where there is none, the reader that a
    family of metrics shares: ``metrics/<base>.py`` for ``<base>.<x>``
    (``rtf.py`` reads ``rtf.rtlsdr`` and ``rtf.ladder4``)."""
    d = Path(bench_dir) / "metrics"
    own = d / f"{name}.py"
    if own.exists() or "." not in name:
        return own
    return d / f"{name.rsplit('.', 1)[0]}.py"


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    return load_module(metric_path(name, bench_dir)).read


def roofline(kernel: str, bench_dir: Path = BENCH_DIR):
    return load_module(Path(bench_dir) / "rooflines" / f"{kernel}.py")


def reference(name: str):
    """The tracking reference a configuration names: the module
    ``reference/<name>.py`` of this benchmark, imported by its name
    (``reference/__init__.py`` says what it provides)."""
    path = BENCH_DIR / "reference" / f"{name}.py"
    if not MODULE_RE.match(name) or not path.is_file():
        raise FileNotFoundError(
            f"no reference tracker {name!r}: {path} is missing")
    package = __package__.rsplit(".", 1)[0]
    return importlib.import_module(f"{package}.reference.{name}")


def check_names(bench: dict) -> list[str]:
    """What in ``bench`` breaks the contract's rules for names and units
    (empty when nothing does)."""
    bad = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = set()
        for e in bench.get(kind, []):
            if not NAME_RE.match(e["name"]):
                bad.append(f"{kind}: name {e['name']!r}")
            if e["name"] in seen:
                bad.append(f"{kind}: {e['name']!r} twice")
            seen.add(e["name"])
            if "unit" in e and not UNIT_RE.match(e["unit"]):
                bad.append(f"{kind}: unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                bad.append(f"{kind}: better {e['better']!r}")
    for c in bench.get("configs", []):
        for k in c.get("reduced", []):
            if not NAME_RE.match(k):
                bad.append(f"reduced key {k!r}")
    for w in bench.get("workloads", []):
        for k in ("config", "traffic"):
            if not NAME_RE.match(w[k]):
                bad.append(f"workload {w['name']}: {k} {w[k]!r}")
    return bad
