"""The port's streaming outputs against the JAX package's, on the CPU: the
RINEX OBS writer and reader, the RINEX nav parser, the EKF navigation
filter, and the receiver's observables cadence inside spans. Inputs come
from numpy with fixed seeds and go to both sides."""
import dataclasses
import datetime
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from gnss_sdr_tpu import ReceiverConfig as JReceiverConfig  # noqa: E402
from gnss_sdr_tpu import RfConfig as JRfConfig  # noqa: E402
from gnss_sdr_tpu.config import AcqConfig as JAcqConfig  # noqa: E402
from gnss_sdr_tpu.config import TrackConfig as JTrackConfig  # noqa: E402
from gnss_sdr_tpu.nav import ephemeris as j_ephemeris  # noqa: E402
from gnss_sdr_tpu.nav import filter as j_filter  # noqa: E402
from gnss_sdr_tpu.nav import rinex as j_rinex  # noqa: E402
from gnss_sdr_tpu.nav import rinex_obs as j_rinex_obs  # noqa: E402
from gnss_sdr_tpu.receiver import ArraySource as JArraySource  # noqa: E402
from gnss_sdr_tpu.receiver import Receiver as JReceiver  # noqa: E402

from gnss_sdr_tpu_torch import (  # noqa: E402
    AcqConfig, ReceiverConfig, RfConfig, TrackConfig)
from gnss_sdr_tpu_torch import constants as C  # noqa: E402
from gnss_sdr_tpu_torch.models import SatelliteScenario, synthesize  # noqa: E402
from gnss_sdr_tpu_torch.nav import (  # noqa: E402
    NavigationFilter, RinexObsWriter, parse_nav_file, parse_obs_file,
    select_ephemerides)
from gnss_sdr_tpu_torch.nav import rinex_obs  # noqa: E402
from gnss_sdr_tpu_torch.nav.orbits import satellite_position  # noqa: E402
from gnss_sdr_tpu_torch.receiver import ArraySource, Receiver  # noqa: E402

FS = 2_046_000.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread: the suite runs test files in parallel
    worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _epochs(seed=4):
    """Ten OBS epochs of five PRNs, one C/N0 missing."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(10):
        obs = {}
        for prn in (3, 7, 12, 19, 30):
            cn0 = None if (k, prn) == (4, 12) else float(rng.uniform(35, 50))
            obs[prn] = (float(rng.uniform(2.0e7, 2.6e7)),
                        float(rng.uniform(-4000, 4000)), cn0)
        out.append((345_600.0 + 0.1 * k + float(rng.uniform(0, 1e-6)), obs))
    return out


class _FixedNow(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5, tzinfo=tz)


def test_obs_writer_bytes_equal_and_cross_parse(tmp_path, monkeypatch):
    # the header's run date is the one thing that varies: the same clock
    fixed = types.SimpleNamespace(**{k: getattr(datetime, k)
                                     for k in dir(datetime)
                                     if not k.startswith("_")})
    fixed.datetime = _FixedNow
    monkeypatch.setattr(rinex_obs, "datetime", fixed)
    monkeypatch.setattr(j_rinex_obs, "datetime", fixed)
    paths = {}
    for name, cls in (("port", RinexObsWriter),
                      ("jax", j_rinex_obs.RinexObsWriter)):
        paths[name] = tmp_path / f"{name}.rnx"
        with cls(str(paths[name]), approx_position=(1.5, -2.25, 3.0)) as w:
            for sow, obs in _epochs():
                w.write_epoch(2290, sow, obs)
        assert w.epochs_written == 10
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    hp, ep = parse_obs_file(str(paths["jax"]))
    hj, ej = j_rinex_obs.parse_obs_file(str(paths["port"]))
    assert hp == hj and ep == ej
    assert hp["obs_types"] == ["C1C", "D1C", "S1C"] and len(ep) == 10
    assert ep[4]["sats"][12][2] is None
    assert rinex_obs.gps_time_to_utc(2290, 100.0) == \
        j_rinex_obs.gps_time_to_utc(2290, 100.0)


def _nav_text():
    """A short RINEX 3.04 GPS nav file: a header and three records of two
    PRNs, in the D exponent notation."""
    def rec(prn, toc, vals):
        def f(x):
            return f"{x:19.12E}".replace("E", "D")
        lines = [f"G{prn:02d} {toc}" + "".join(f(v) for v in vals[:3])]
        for k in range(3, 31, 4):
            lines.append("    " + "".join(f(v) for v in vals[k:k + 4]))
        return lines

    rng = np.random.default_rng(11)
    head = [
        f"{'     3.04':<20s}{'N: GNSS NAV DATA':<20s}{'G: GPS':<20s}"
        "RINEX VERSION / TYPE",
        f"{'GPSA   1.1176D-08 -1.4901D-08 -5.9605D-08  1.1921D-07':<60s}"
        "IONOSPHERIC CORR",
        f"{'GPSB   1.1264D+05 -1.1469D+05 -1.3107D+05  8.5197D+05':<60s}"
        "IONOSPHERIC CORR",
        f"{'GPUT -3.7252902985D-09-1.243449788D-14 233472 2290':<60s}"
        "TIME SYSTEM CORR",
        f"{'    18':<60s}LEAP SECONDS",
        f"{'':<60s}END OF HEADER",
    ]
    body = []
    for prn, toc in ((5, "2023 11 29 16 00 00"), (5, "2023 11 29 18 00 00"),
                     (14, "2023 11 29 16 00 00")):
        vals = list(rng.uniform(-1e-3, 1e-3, 31))
        vals[3] = 71.0          # iode
        vals[10] = 5153.6 + rng.uniform(0, 1)   # sqrt_a
        vals[11] = 316_800.0    # t_oe
        vals[21] = 2290.0       # week
        vals[23], vals[24] = 2.0, 0.0   # ura, health
        vals[26] = 71.0         # iodc
        body += rec(prn, toc, vals)
    return "\n".join(head + body) + "\n"


def test_parse_nav_file_equal(tmp_path):
    path = tmp_path / "brdc.rnx"
    path.write_text(_nav_text())
    hp, rp = parse_nav_file(str(path))
    hj, rj = j_rinex.parse_nav_file(str(path))
    assert dataclasses.asdict(hp) == dataclasses.asdict(hj)
    assert hp.leap_seconds == 18 and hp.iono_alpha[0] == 1.1176e-08
    assert len(rp) == len(rj) == 3
    for a, b in zip(rp, rj):
        assert a.prn == b.prn and a.toc == b.toc
        assert dataclasses.asdict(a.eph) == dataclasses.asdict(b.eph)
    at = datetime.datetime(2023, 11, 29, 17, 40, tzinfo=datetime.timezone.utc)
    sp, sj = select_ephemerides(rp, at), j_rinex.select_ephemerides(rj, at)
    assert sorted(sp) == sorted(sj) == [5, 14]
    assert dataclasses.asdict(sp[5]) == dataclasses.asdict(sj[5])
    assert sp[5].t_oc == rp[1].eph.t_oc


def _filter_inputs(n_epochs=12, seed=2):
    """Pseudoranges and Dopplers of the nav scene's satellites (in-test
    Kepler ephemerides) at ``n_epochs`` receive times 0.5 s apart, with
    noise, and the ephemerides in both packages' types."""
    ephs = chip_smoke.nav_ephemerides()
    rng = np.random.default_rng(seed)
    epochs = []
    for k in range(n_epochs):
        t_rx = chip_smoke.NAV_T_RX0 + 0.5 * k
        prns = sorted(ephs)[: 5 + k % 4]      # 5 to 8 satellites
        prs, txs, dops = [], [], []
        for prn in prns:
            d = chip_smoke.nav_delay(ephs[prn], t_rx)
            d1 = chip_smoke.nav_delay(ephs[prn], t_rx + 1e-3)
            prs.append(-d * C.SPEED_OF_LIGHT_M_S + rng.normal(0, 3.0))
            txs.append(t_rx + d)
            dops.append(C.GPS_L1_FREQ_HZ * (d1 - d) / 1e-3
                        + rng.normal(0, 0.5))
        epochs.append((prns, prs, txs, dops))
    return ephs, epochs


def test_navigation_filter_equal():
    ephs, epochs = _filter_inputs()
    j_ephs = {p: j_ephemeris.Ephemeris(**dataclasses.asdict(e))
              for p, e in ephs.items()}
    a, b = NavigationFilter(), j_filter.NavigationFilter()
    for k, (prns, prs, txs, dops) in enumerate(epochs):
        if k:
            a.predict(0.5)
            b.predict(0.5)
        use = dops if k % 3 else None         # some epochs pseudorange only
        ok_a = a.update(prs, [ephs[p] for p in prns], txs, dopplers_hz=use)
        ok_b = b.update(prs, [j_ephs[p] for p in prns], txs, dopplers_hz=use)
        assert ok_a and ok_b
        np.testing.assert_allclose(a.x, b.x, rtol=1e-9, atol=0)
        np.testing.assert_allclose(a.p, b.p, rtol=1e-9,
                                   atol=1e-9 * np.abs(b.p).max())
    assert a.epochs == b.epochs == len(epochs)
    # the filter converged on the scene's receiver
    assert np.linalg.norm(a.position - chip_smoke.NAV_RX_TRUE) < 10.0
    assert np.linalg.norm(a.velocity) < 1.0
    pos, _, _ = satellite_position(ephs[2], chip_smoke.NAV_T_OE)
    assert np.linalg.norm(pos) == pytest.approx(chip_smoke.NAV_RADIUS_M,
                                                abs=1.0)


SATS = [dict(prn=3, doppler_hz=700.0, amplitude=0.3),
        dict(prn=7, doppler_hz=-450.0, amplitude=0.3)]


def _count_attempts(rx):
    calls = {"n": 0}
    orig = rx.nav.observables

    def counting():
        calls["n"] += 1
        return orig()

    rx.nav.observables = counting
    return calls


def test_observables_cadence_in_spans_matches_jax():
    """One emission attempt per block inside spans of 4, as in the JAX
    receiver (tests/test_observability.py's scene, the FFT engine)."""
    sig = synthesize([SatelliteScenario(**s) for s in SATS], int(0.6 * FS),
                     FS, noise_std=1.0, seed=8)
    rx = Receiver(ReceiverConfig(
        rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
        acq=AcqConfig(engine="fft", steady_threshold=2),
        track=TrackConfig(n_channels=4, correlator="fused",
                          fused_layout="mxu"),
        block_ms=20), ArraySource(sig, FS), device="cpu")
    jrx = JReceiver(JReceiverConfig(
        rf=JRfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
        acq=JAcqConfig(engine="fft", steady_threshold=2),
        track=JTrackConfig(n_channels=4, correlator="fused",
                           fused_layout="mxu"),
        block_ms=20), JArraySource(sig, FS))
    counts = []
    for r in (rx, jrx):
        calls = _count_attempts(r)
        r.enable_observables(every_ms=20)
        s = r.run(scan_blocks=4)
        counts.append((calls["n"], s["blocks"],
                       s["stage_timing"]["track"]["calls"]))
    assert counts[0] == counts[1], counts
    n, blocks, track_calls = counts[0]
    assert track_calls < blocks            # spans ran
    assert n >= blocks - 2, counts


def test_observables_stream_to_rinex_and_ekf(tmp_path):
    """enable_observables on the port's receiver writes what the nav
    chain produces: the writer and the filter see every epoch that
    observables() returns (an in-test stand-in for the decoded nav)."""
    ephs, epochs = _filter_inputs(n_epochs=6)
    sig = synthesize([SatelliteScenario(**s) for s in SATS], int(0.2 * FS),
                     FS, noise_std=1.0, seed=8)
    rx = Receiver(ReceiverConfig(
        rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
        track=TrackConfig(n_channels=4), block_ms=20), ArraySource(sig, FS),
        device="cpu")
    feed = iter(epochs)

    def observables():
        prns, prs, txs, _ = next(feed)
        return {"prns": prns, "pseudoranges_m": prs, "transmit_times_s": txs,
                "ephemerides": [ephs[p] for p in prns],
                "rx_time_nominal_s": txs[0] + 0.07}

    rx.nav.observables = observables
    obs_path = tmp_path / "obs.rnx"
    rx.enable_observables(rinex_path=str(obs_path), every_ms=40, week=2290,
                          ekf=True)
    out = rx.run(max_blocks=10)
    rx._obs_writer.close()
    assert out["blocks"] == 10
    # 200 ms of blocks at a 40 ms cadence from t = 40 ms: 5 epochs
    _, parsed = parse_obs_file(str(obs_path))
    assert rx._obs_writer.epochs_written == len(parsed) == 5
    assert rx.nav_filter.epochs == 5
    assert [sorted(e["sats"]) for e in parsed] == [ep[0] for ep in epochs[:5]]
