"""The port's per-epoch fused layouts through FusedTracker and the
Receiver, on the CPU, against the JAX package: ``run_block`` on the seg
and windows layouts and at an odd epoch count (which falls from mxu to
direct to seg on both sides) over several blocks from the same ledger,
and ``Receiver.run`` at 15 ms blocks (seg) and on the windows layout
against the JAX receiver on the same scene."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gnss_sdr_tpu import ReceiverConfig as JReceiverConfig  # noqa: E402
from gnss_sdr_tpu import RfConfig as JRfConfig  # noqa: E402
from gnss_sdr_tpu.config import AcqConfig as JAcqConfig  # noqa: E402
from gnss_sdr_tpu.config import TrackConfig as JTrackConfig  # noqa: E402
from gnss_sdr_tpu.models import GPS_L1CA as J_GPS  # noqa: E402
from gnss_sdr_tpu.models import SatelliteScenario as JSat  # noqa: E402
from gnss_sdr_tpu.receiver import Receiver as JReceiver  # noqa: E402
from gnss_sdr_tpu.receiver import SyntheticSource as JSyntheticSource  # noqa: E402
from gnss_sdr_tpu.receiver import fused_runner as j_fr  # noqa: E402
from gnss_sdr_tpu.receiver import tracking as j_trk  # noqa: E402

from gnss_sdr_tpu_torch import (  # noqa: E402
    AcqConfig, ReceiverConfig, RfConfig, TrackConfig)
from gnss_sdr_tpu_torch.models import (  # noqa: E402
    GPS_L1CA, SatelliteScenario, synthesize)
from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep  # noqa: E402
from gnss_sdr_tpu_torch.receiver import Receiver, SyntheticSource  # noqa: E402
from gnss_sdr_tpu_torch.receiver import fused_runner as fr  # noqa: E402
from gnss_sdr_tpu_torch.receiver import tracking as trk  # noqa: E402

FS = 2_046_000.0
N0 = GPS_L1CA.samples_per_code(FS)
C = 4
HISTORY = 2 * N0 + 8192


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# FusedTracker.run_block, port against JAX
# ---------------------------------------------------------------------------

def _run_blocks_both(layout, t_epochs, n_blocks=2):
    """Both trackers over ``n_blocks`` blocks of one scene from the same
    ledger: 4 channels at offsets off the 128 grid (the JAX suite's
    TestLayoutParity offsets N0 + 37 + 101 ch)."""
    block = t_epochs * N0
    dopplers = [900.0 + 130.0 * c for c in range(C)]
    sats = [SatelliteScenario(prn=c + 1, doppler_hz=dopplers[c],
                              code_phase_chips=(-(N0 + 37 + 101 * c)
                                                * 1.023e6 / FS) % 1023)
            for c in range(C)]
    sig = synthesize(sats, HISTORY + n_blocks * block, FS, noise_std=0.3,
                     seed=2)
    sre = np.real(sig).astype(np.float32)
    sim = np.imag(sig).astype(np.float32)
    jcfg = JTrackConfig(n_channels=C, correlator="fused")
    cfg = TrackConfig(n_channels=C, correlator="fused")
    jparams = j_trk.TrackParams.create(jcfg, J_GPS, FS)
    params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
    codes = trk.make_sampled_code_table(GPS_L1CA, FS, 32,
                                        window=params.window)
    jft = j_fr.FusedTracker(jparams, jcfg, J_GPS, FS, jnp.asarray(codes),
                            t_epochs, HISTORY + block, layout=layout)
    ft = fr.FusedTracker(params, cfg, GPS_L1CA, FS, codes, t_epochs,
                         HISTORY + block, layout=layout, device="cpu")
    assert ft.layout == jft.layout
    assert (ft.wp, ft.n_rows, ft.max_offset, ft.wire) == \
        (jft.wp, jft.n_rows, jft.max_offset, jft.wire)
    jst = j_trk.init_state(C)
    for ch in range(C):
        jst = j_trk.start_channel(jst, ch, ch, dopplers[ch],
                                  N0 + 37 + 101 * ch, J_GPS.code_rate_hz)
    st = trk.state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()})
    rows = codes[:C]
    out = []
    for b in range(n_blocks):
        w = slice(b * block, b * block + HISTORY + block)
        jst, jtl = jft.run_block(jst, jnp.asarray(sre[w]),
                                 jnp.asarray(sim[w]), jnp.asarray(rows))
        st, tl = ft.run_block(st, sre[w], sim[w], torch.from_numpy(rows))
        out.append((jtl, tl))
        jst = j_trk.rebase(jst, block)
        st = trk.rebase(st, block)
    return ft, jst, st, out


@pytest.mark.parametrize("layout,t_epochs,resolved", [
    ("seg", 20, "seg"), ("windows", 20, "windows"), ("mxu", 15, "seg")],
    ids=["seg", "windows", "odd_T"])
def test_run_block_matches_jax(layout, t_epochs, resolved):
    before = (ep.seg_launch_count, ep.gather_launch_count,
              ep.windows_launch_count)
    ft, jst, st, out = _run_blocks_both(layout, t_epochs)
    assert ft.layout == resolved
    if resolved == "seg":
        assert ft.l_seg == ep.seg_length(t_epochs, N0, ft.wp)
    # the plain versions ran (CPU tensors), which never count
    assert (ep.seg_launch_count, ep.gather_launch_count,
            ep.windows_launch_count) == before
    for f in ("offset", "epochs", "active", "chip_int"):
        np.testing.assert_array_equal(getattr(st, f),
                                      np.asarray(getattr(jst, f)), f)
    for jtl, tl in out:
        for f in ("processed", "start_offset", "epoch_index", "locked",
                  "lost_event"):
            np.testing.assert_array_equal(getattr(tl, f),
                                          np.asarray(getattr(jtl, f)), f)
        for f in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "power",
                  "pll_err", "dll_err", "carr_freq", "code_rate",
                  "chip_phase"):
            a, b = np.asarray(getattr(jtl, f)), getattr(tl, f)
            np.testing.assert_allclose(
                b, a, rtol=2e-5, atol=2e-4 * max(1.0, np.abs(a).max()),
                err_msg=f)
    np.testing.assert_allclose(st.carr_freq, np.asarray(jst.carr_freq),
                               rtol=1e-5)
    assert np.all(st.active)


def test_spans_refuse_the_per_epoch_layouts():
    cfg = TrackConfig(n_channels=2, correlator="fused")
    params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
    codes = trk.make_sampled_code_table(GPS_L1CA, FS, 2,
                                        window=params.window)
    for layout in ("seg", "windows"):
        ft = fr.FusedTracker(params, cfg, GPS_L1CA, FS, codes, 20,
                             HISTORY + 20 * N0, layout=layout, wire="slim2",
                             device="cpu")
        # slim2 rides the mxu kernel's held-rate columns
        assert (ft.wire, ft.k_epochs) == ("slim", None)
        with pytest.raises(ValueError, match="'direct' or 'mxu'"):
            ft.submit_span(trk.init_state(2), np.zeros(HISTORY + 20 * N0),
                           np.zeros(HISTORY + 20 * N0), codes[:2], 1)


# ---------------------------------------------------------------------------
# the Receiver, port against JAX
# ---------------------------------------------------------------------------

SATS = [dict(prn=5, doppler_hz=2100.0, amplitude=0.35),
        dict(prn=9, doppler_hz=-1500.0, amplitude=0.35)]
N_BLOCKS = 12
RX_CASES = {"seg_15ms": (15, {}), "windows_20ms": (20, dict(
    fused_layout="windows"))}


def _cfg(mod, block_ms, track_kw):
    return mod["ReceiverConfig"](
        rf=mod["RfConfig"](freq_if_hz=0.0, output_sample_rate_hz=FS),
        acq=mod["AcqConfig"](),
        track=mod["TrackConfig"](n_channels=4, correlator="fused",
                                 **track_kw),
        block_ms=block_ms)


@pytest.fixture(scope="module", params=list(RX_CASES))
def both_receivers(request):
    block_ms, track_kw = RX_CASES[request.param]
    jrx = JReceiver(
        _cfg(dict(ReceiverConfig=JReceiverConfig, RfConfig=JRfConfig,
                  AcqConfig=JAcqConfig, TrackConfig=JTrackConfig),
             block_ms, track_kw),
        JSyntheticSource([JSat(**s) for s in SATS], FS, noise_std=1.0,
                         seed=13))
    rx = Receiver(
        _cfg(dict(ReceiverConfig=ReceiverConfig, RfConfig=RfConfig,
                  AcqConfig=AcqConfig, TrackConfig=TrackConfig),
             block_ms, track_kw),
        SyntheticSource([SatelliteScenario(**s) for s in SATS], FS,
                        noise_std=1.0, seed=13), device="cpu")
    return request.param, jrx, jrx.run(max_blocks=N_BLOCKS), rx, \
        rx.run(max_blocks=N_BLOCKS)


def test_receiver_matches_jax(both_receivers):
    name, jrx, js, rx, s = both_receivers
    layout = "seg" if name.startswith("seg") else "windows"
    assert rx.fused.layout == jrx.fused.layout == layout
    assert [(c.prn, c.sample_local_index) for _, c in rx.acq_events] == \
        [(c.prn, c.sample_local_index) for _, c in jrx.acq_events]
    assert s["tracked_prns"] == js["tracked_prns"] == [5, 9]
    assert s["blocks"] == js["blocks"] == N_BLOCKS
    jch = {c["prn"]: c for c in js["channels"]}
    for c in s["channels"]:
        j = jch[c["prn"]]
        assert c["epochs"] == j["epochs"]
        d = abs(c["last_doppler_hz"] - j["last_doppler_hz"])
        print(f"\nPRN {c['prn']} [{name}]: epochs {c['epochs']}, last "
              f"Doppler port - JAX = {d} Hz")
        assert d < 1.0
        assert c["locked_fraction"] > 0.9
