"""The port's ingest against the JAX package's, on the CPU: the device
sources (DeviceArraySource, StreamingDeviceSource) on the CPU device, the
receiver's block pull of device-resident blocks, and the native ingest
(native/ingest.cpp built into the port's build directory). Inputs come
from numpy with fixed seeds and go to both sides."""
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gnss_sdr_tpu.io import native as j_native  # noqa: E402
from gnss_sdr_tpu.receiver import stream as j_stream  # noqa: E402

from gnss_sdr_tpu_torch import (  # noqa: E402
    AcqConfig, ReceiverConfig, RfConfig, TrackConfig)
from gnss_sdr_tpu_torch.io import (  # noqa: E402
    NativeFileSource, convert, native, native_available)
from gnss_sdr_tpu_torch.models import SatelliteScenario, synthesize  # noqa: E402
from gnss_sdr_tpu_torch.receiver import (  # noqa: E402
    ArraySource, DeviceArraySource, FileSource, Receiver,
    StreamingDeviceSource)

FS = 2_046_000.0
CPU = "cpu"
SATS = [dict(prn=5, doppler_hz=2100.0, amplitude=0.35),
        dict(prn=9, doppler_hz=-1500.0, amplitude=0.35)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread: the suite runs test files in parallel
    worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sig():
    return synthesize([SatelliteScenario(**s) for s in SATS], int(0.3 * FS),
                      FS, noise_std=1.0, seed=13)


def _drain(src, n):
    out = []
    while (b := src.read(n)) is not None:
        out.append(b)
    return out


def test_device_array_source_f32_equals_array_source(sig):
    n = 20_460
    a = _drain(ArraySource(sig, FS), n)
    d = _drain(DeviceArraySource(sig, FS, device=CPU), n)
    assert len(a) == len(d) == -(-sig.size // n)
    for x, (re, im) in zip(a, d):
        assert re.device.type == "cpu" and re.dtype == torch.float32
        np.testing.assert_array_equal(re.numpy(), x.real)
        np.testing.assert_array_equal(im.numpy(), x.imag)


@pytest.mark.parametrize("planar", [False, True])
def test_device_array_source_int8_equals_jax(sig, planar):
    n = 40_920
    src = ((sig.real.astype(np.float32), sig.imag.astype(np.float32))
           if planar else sig)
    port = _drain(DeviceArraySource(src, FS, store="int8", device=CPU), n)
    jax = _drain(j_stream.DeviceArraySource(src, FS, store="int8"), n)
    assert len(port) == len(jax)
    for (pre, pim), (jre, jim) in zip(port, jax):
        np.testing.assert_array_equal(pre.numpy(), np.asarray(jre))
        np.testing.assert_array_equal(pim.numpy(), np.asarray(jim))
    with pytest.raises(ValueError, match="store"):
        DeviceArraySource(sig, FS, store="f16", device=CPU)


def test_streaming_source_equals_jax(sig):
    n = 40_920
    for store in ("int8", "f32"):
        port = StreamingDeviceSource(ArraySource(sig, FS), store=store,
                                     device=CPU)
        jax = j_stream.StreamingDeviceSource(j_stream.ArraySource(sig, FS),
                                             store=store)
        try:
            a, b = _drain(port, n), _drain(jax, n)
        finally:
            port.close()
            jax.close()
        assert len(a) == len(b) == -(-sig.size // n)
        for (pre, pim), (jre, jim) in zip(a, b):
            np.testing.assert_array_equal(pre.numpy(), np.asarray(jre))
            np.testing.assert_array_equal(pim.numpy(), np.asarray(jim))
        st = port.stats()
        assert st["reads"] == len(a) + 1            # the end-of-stream read
        assert set(st) == set(jax.stats())
        assert st["max_queue_depth"] <= 3
    with pytest.raises(ValueError, match="block size"):
        s = StreamingDeviceSource(ArraySource(sig, FS), device=CPU)
        try:
            s.read(n)
            s.read(n + 1)
        finally:
            s.close()


def test_streaming_source_close_mid_stream():
    """close() while the feeder is blocked on a full queue of an endless
    source returns, and the feeder ends."""
    class Endless:
        fs_hz = FS

        def read(self, n):
            return np.ones(n, np.complex64)

    src = StreamingDeviceSource(Endless(), depth=2, device=CPU)
    src.read(1000)
    time.sleep(0.5)                     # the feeder fills the queue
    done = threading.Event()
    closer = threading.Thread(target=lambda: (src.close(), done.set()),
                              daemon=True)
    t0 = time.perf_counter()
    closer.start()
    closer.join(timeout=20.0)
    assert done.is_set(), "close() did not return"
    assert not src._thread.is_alive()
    assert time.perf_counter() - t0 < 20.0


def _run_bounded(fn, timeout=120.0):
    """fn() on a daemon thread, joined with a timeout: a hang fails the
    test instead of the run."""
    out = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    th = threading.Thread(target=body, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), "hung"
    if "error" in out:
        raise out["error"]
    return out["value"]


def test_streaming_source_end_of_stream_is_sticky(sig):
    """After its end of stream the source keeps returning None: a
    receiver in spans reads again after a short span (ROADMAP C14)."""
    rx = _receiver(StreamingDeviceSource(ArraySource(sig, FS), store="f32",
                                         device=CPU))
    ref = _receiver(ArraySource(sig, FS))
    try:
        s = _run_bounded(lambda: rx.run(scan_blocks=4))
    finally:
        rx.source.close()
    assert rx.source.read(20 * 2046) is None
    want = ref.run(scan_blocks=4)
    assert s["blocks"] == want["blocks"] == -(-sig.size // (20 * 2046))
    assert s["tracked_prns"] == want["tracked_prns"] == [5, 9]


def test_streaming_source_feeder_error_reaches_reader():
    class Broken:
        fs_hz = FS

        def read(self, n):
            raise OSError("device unplugged")

    src = StreamingDeviceSource(Broken(), device=CPU)
    with pytest.raises(RuntimeError, match="feeder failed") as e:
        _run_bounded(lambda: src.read(1000), timeout=30.0)
    assert isinstance(e.value.__cause__, OSError)
    assert src.read(1000) is None
    src.close()


def _receiver(source, **kw):
    return Receiver(ReceiverConfig(
        rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
        acq=AcqConfig(steady_threshold=2),
        track=TrackConfig(n_channels=4, correlator="fused", **kw),
        block_ms=20), source, device=CPU)


_RUN_ONLY = ("stage_timing",)


@pytest.mark.parametrize("scan_blocks", [1, 4])
def test_receiver_on_device_source_equals_array_source(sig, scan_blocks):
    runs = []
    for src in (ArraySource(sig, FS), DeviceArraySource(sig, FS, device=CPU)):
        rx = _receiver(src)
        s = rx.run(scan_blocks=scan_blocks)
        runs.append((rx, {k: v for k, v in s.items() if k not in _RUN_ONLY}))
    (ra, sa), (rd, sd) = runs
    assert sa == sd
    assert sa["tracked_prns"] == [5, 9]
    for ch, t in ra.telemetry.traces.items():
        np.testing.assert_array_equal(t.i_p, rd.telemetry.traces[ch].i_p)
        np.testing.assert_array_equal(t.carr_freq,
                                      rd.telemetry.traces[ch].carr_freq)


def test_pull_block_takes_tensors_as_they_are(sig):
    block = 20 * 2046
    rx = _receiver(DeviceArraySource(sig[:block + 1000], FS, device=CPU))
    (re, im), n_valid = rx._pull_block()
    assert n_valid == block and re.shape == (block,)
    (re, im), n_valid = rx._pull_block()    # a short read, zero-padded
    assert n_valid == 1000 and re.shape == (block,)
    np.testing.assert_array_equal(re[:1000], sig[block:block + 1000].real)
    assert not re[1000:].any() and not im[1000:].any()
    assert rx._pull_block() is None

    class Elsewhere:
        fs_hz = FS

        def read(self, n):
            t = torch.zeros(n, device="meta")
            return (t, t)

    with pytest.raises(ValueError, match="meta"):
        _receiver(Elsewhere())._pull_block()


needs_compiler = pytest.mark.skipif(
    shutil.which("g++") is None, reason="no C++ compiler to build "
    "native/ingest.cpp")


@needs_compiler
@pytest.mark.parametrize("wire", ["int8_real", "int8_iq", "uint8_iq",
                                  "int16_iq"])
def test_convert_equals_numpy_and_jax(wire):
    assert native_available()
    raw = np.random.default_rng(1).integers(0, 256, 10_001, dtype=np.uint8)
    bps = native._BYTES_PER_SAMPLE[wire]
    got = convert(raw, wire)
    assert got.dtype == np.complex64 and got.size == raw.size // bps
    np.testing.assert_array_equal(
        got, native._convert_numpy(raw[:got.size * bps], wire))
    np.testing.assert_array_equal(got, j_native.convert(raw, wire))
    with pytest.raises(ValueError, match="wire format"):
        convert(raw, "int4_iq")


@needs_compiler
@pytest.mark.parametrize("wire", ["int8_real", "int8_iq"])
def test_native_file_source_equals_file_source(tmp_path, wire):
    raw = np.random.default_rng(2).integers(-128, 128, 300_007,
                                            dtype=np.int8)
    path = tmp_path / "capture.bin"
    path.write_bytes(raw.tobytes())
    nat = NativeFileSource(str(path), FS, wire)
    try:
        a = _drain(nat, 20_000)
    finally:
        nat.close()
    fsrc = FileSource(str(path), FS, wire)
    try:
        b = _drain(fsrc, 20_000)
    finally:
        fsrc.close()
    assert len(a) == len(b)
    np.testing.assert_array_equal(np.concatenate(a), np.concatenate(b))
    with pytest.raises(FileNotFoundError):
        NativeFileSource(str(tmp_path / "missing.bin"), FS, wire)


def test_no_compiler_means_numpy_fallback(monkeypatch):
    """Where no compiler exists: native_available() is False, convert
    takes the numpy path, and the native source says why it cannot
    start."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_compiler", lambda: None)
    assert not native_available()
    raw = np.arange(64, dtype=np.uint8)
    np.testing.assert_array_equal(convert(raw, "int8_iq"),
                                  native._convert_numpy(raw, "int8_iq"))
    with pytest.raises(RuntimeError, match="compiler"):
        NativeFileSource("/nonexistent", FS, "int8_iq")


@pytest.mark.skipif(shutil.which("false") is None, reason="no false(1)")
def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails raises with its output: nothing falls back
    silently."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_compiler", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="failed"):
        native_available()
    assert list(tmp_path.iterdir()) == []
