"""The port's command line against the JAX package's, on the CPU:
``cli.main`` on the built-in synthetic scene and on a TOML with the file
driver over an int8 capture, the refusal without a card, and the
application layer around it (plots, the live view, the profiler trace,
the host allocator)."""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gnss_sdr_tpu import cli as j_cli  # noqa: E402

from gnss_sdr_tpu_torch import cli  # noqa: E402
from gnss_sdr_tpu_torch.io import NativeFileSource, native_available  # noqa: E402
from gnss_sdr_tpu_torch.models import SatelliteScenario, synthesize  # noqa: E402
from gnss_sdr_tpu_torch.receiver import FileSource  # noqa: E402
from gnss_sdr_tpu_torch.utils import host, live, profiling  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FS = 2_046_000.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread: the suite runs test files in parallel
    worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr().out
    return json.loads(out.strip().splitlines()[-1])


def _same_summary(port, jax):
    assert port["tracked_prns"] == jax["tracked_prns"]
    assert port["blocks"] == jax["blocks"]
    pc = {c["prn"]: c for c in port["channels"]}
    jc = {c["prn"]: c for c in jax["channels"]}
    assert sorted(pc) == sorted(jc)
    for prn in pc:
        assert pc[prn]["epochs"] == jc[prn]["epochs"], prn
        # tests/test_torch_receiver.py's tolerance
        assert abs(pc[prn]["last_doppler_hz"]
                   - jc[prn]["last_doppler_hz"]) < 1.0, prn


def test_builtin_scene_matches_jax(capsys):
    argv = ["--cpu", "--json", "--blocks", "8"]
    port = _run(cli.main, argv, capsys)
    jax = _run(j_cli.main, argv, capsys)
    assert port["tracked_prns"] == [3, 9, 17]
    _same_summary(port, jax)
    assert port["time_ms"] == 160.0 and port["wall_s"] > 0


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A 0.4 s int8 I/Q capture of two satellites and its TOML."""
    d = tmp_path_factory.mktemp("cli")
    sats = [SatelliteScenario(prn=6, doppler_hz=1200.0, code_phase_chips=80.5,
                              amplitude=0.35),
            SatelliteScenario(prn=21, doppler_hz=-2300.0,
                              code_phase_chips=611.0, amplitude=0.35)]
    x = synthesize(sats, int(0.4 * FS), FS, noise_std=1.0, seed=21)
    iq = np.empty(2 * x.size, np.float32)
    iq[0::2], iq[1::2] = x.real, x.imag
    path = d / "capture.int8_iq"
    path.write_bytes(np.clip(np.round(iq * 16.0), -127, 127)
                     .astype(np.int8).tobytes())
    toml = d / "rx.toml"
    toml.write_text(f"""block_ms = 20

[sdr]
driver = "file"
path = "{path}"
file_format = "int8_iq"
sample_rate_hz = {FS!r}

[rf]
freq_if_hz = 0.0
output_sample_rate_hz = {FS!r}

[track]
n_channels = 4
""")
    return path, toml


def test_file_driver_matches_jax(capture, capsys, tmp_path):
    path, toml = capture
    from gnss_sdr_tpu_torch.config import from_toml

    src = cli.build_source(from_toml(str(toml)))
    try:
        want = NativeFileSource if native_available() else FileSource
        assert type(src) is want
    finally:
        src.close()
    argv = ["--config", str(toml), "--cpu", "--json", "--blocks", "8"]
    port = _run(cli.main, argv, capsys)
    jax = _run(j_cli.main, argv, capsys)
    assert port["tracked_prns"] == [6, 21]
    _same_summary(port, jax)


def test_cli_refuses_without_card(capsys):
    """Without --cpu and without a card the CLI exits with
    resolve_device's error; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cli.main(["--blocks", "1"])
    assert "CUDA" in str(e.value.code) and "--cpu" in str(e.value.code)
    out = subprocess.run(
        [sys.executable, "-m", "gnss_sdr_tpu_torch", "--blocks", "1"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    assert out.stdout == ""


def test_cli_observables_dashboard_and_live(capture, tmp_path, capsys):
    """--rinex-obs opens its file (an unwritable target exits cleanly),
    --live renders frames, --dashboard writes a PNG."""
    _, toml = capture
    base = ["--config", str(toml), "--cpu", "--blocks", "3"]
    with pytest.raises(SystemExit, match="rinex-obs"):
        cli.main(base + ["--rinex-obs", str(tmp_path / "no" / "x.rnx")])
    assert cli.main(base + ["--rinex-obs", str(tmp_path / "o.rnx"),
                            "--ekf", "--live", "--live-fps", "1000"]) == 0
    cap = capsys.readouterr()
    assert "tracking PRNs: [6, 21]" in cap.out
    assert "observables ->" in cap.err and "PRN" in cap.err
    assert (tmp_path / "o.rnx").exists()
    pytest.importorskip("matplotlib")
    png = tmp_path / "dash.png"
    assert cli.main(base + ["--dashboard", str(png)]) == 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_live_view_text(capture):
    from gnss_sdr_tpu_torch.config import from_toml
    from gnss_sdr_tpu_torch.receiver import Receiver

    _, toml = capture
    cfg = from_toml(str(toml))
    src = cli.build_source(cfg)
    rx = Receiver(cfg, src, device="cpu")
    frames = []

    class Sink:
        def write(self, s):
            frames.append(s)

        def flush(self):
            pass

        def isatty(self):
            return False

    view = live.LiveView(rx, interval_s=0.0, stream=Sink())
    rx.run(max_blocks=4, on_block=view)
    src.close()
    assert view.renders == 4
    last = frames[-1]
    assert "channels 2/4 active" in last and "fix: - (0 ephemerides" in last
    assert "   6 " in last and "  21 " in last


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    files = list((tmp_path / "tr").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::sum" in str(e.get("name")) for e in events)
    assert prof.key_averages() is not None


def test_plots_write_png(tmp_path):
    pytest.importorskip("matplotlib")
    from gnss_sdr_tpu_torch.utils import view

    x = synthesize([SatelliteScenario(prn=1, amplitude=0.5)], 16_384, FS,
                   noise_std=1.0, seed=0)
    view.plot_psd(x, FS, str(tmp_path / "psd.png"))
    view.acquisition_heatmap(np.random.default_rng(0).random((5, 64)),
                             np.linspace(-1000, 1000, 5), FS,
                             str(tmp_path / "heat.png"))
    for name in ("psd.png", "heat.png"):
        assert (tmp_path / name).read_bytes()[:4] == b"\x89PNG"


def test_power_spectrum_and_host_allocator_match_jax():
    from gnss_sdr_tpu.utils import view as j_view
    from gnss_sdr_tpu_torch.utils import view

    x = synthesize([SatelliteScenario(prn=1, doppler_hz=250_000.0)], 65_536,
                   FS, noise_std=0.5, seed=1)
    fa, pa = view.power_spectrum(x, FS, nfft=2048)
    fb, pb = j_view.power_spectrum(x, FS, nfft=2048)
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(pa, pb)
    ok = host.tune_host_allocator()
    assert isinstance(ok, bool) and host.tune_host_allocator() is ok


def test_plot_without_matplotlib_names_it(monkeypatch, tmp_path):
    from gnss_sdr_tpu_torch.utils import view

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        view.plot_psd(np.ones(64, np.complex64), FS, str(tmp_path / "x.png"),
                      nfft=32)
