"""The port's full-chain demo (examples/torch_full_receiver_demo.py) on
the CPU: 2 s of its LNAV sky from a cold start, both satellites tracked,
PRN 7's bits synchronized, the dashboard written; the script imports no
JAX and nothing of the JAX package."""
import ast
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

DEMO = (pathlib.Path(__file__).resolve().parents[1] / "examples"
        / "torch_full_receiver_demo.py")


def test_demo_imports_no_jax():
    mods = set()
    for node in ast.walk(ast.parse(DEMO.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    assert not {m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                       "gnss_sdr_tpu")}
    assert "gnss_sdr_tpu_torch.receiver" in mods


def test_demo_runs_on_cpu(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location("torch_demo", DEMO)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = demo.main(["--cpu", "--seconds", "2",
                         "--dashboard", str(tmp_path / "dash.png")])
    finally:
        torch.set_num_threads(n)
    assert out["tracked_prns"] == [7, 18]
    assert out["time_ms"] == 2000.0
    nav = {v["prn"]: v for v in out["nav"].values()}
    assert nav[7]["bit_synced"]
    text = capsys.readouterr().out
    assert "on cpu" in text
    pytest.importorskip("matplotlib")
    assert (tmp_path / "dash.png").stat().st_size > 0
