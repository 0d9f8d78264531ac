"""The port's scanned tracker (receiver/tracking.py::track_block) against
the JAX package's ``track_block`` on the CPU, for the four correlators
("pallas" through B5's CPU path, the JAX side in Pallas interpret mode):
power and Costas lock, carrier aiding on and off, a ``valid_len`` tail,
and idle, deferred and lost channels.

Each block is held to JAX twice:
  * open loop, epoch by epoch: both packages run one epoch from the JAX
    package's state at that epoch, and the whole integer ledger
    (offset, epochs, lost count, chip index, the u32 carrier and chip
    accumulators, the flags) comes out EQUAL;
  * closed loop, the whole block from the common start: the flags,
    offsets and epoch counts equal, the u32 carrier and code phases
    within 1e-4 cycles and chips (the closed loops carry the ulps of the
    two frameworks' CPU sin/cos/atan into the f32 rates, and a rate an
    ulp apart steps the u32 accumulators a few counts apart).
Float tolerances on both: rates (carr_freq, code_rate) rtol 1e-4 above
a 1 mHz floor; sums, discriminators, chip phase and the loop-filter
memories within 1e-4 of their column's max. Scenes are code-aligned
(each channel starts on its satellite's code boundary), so the closed
loops keep those ulps ulps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gnss_sdr_tpu.config import TrackConfig as JTrackConfig  # noqa: E402
from gnss_sdr_tpu.models import GPS_L1CA as J_GPS  # noqa: E402
from gnss_sdr_tpu.receiver import tracking as j_trk  # noqa: E402

from gnss_sdr_tpu_torch.config import TrackConfig  # noqa: E402
from gnss_sdr_tpu_torch.models import (  # noqa: E402
    GPS_L1CA, SatelliteScenario, synthesize)
from gnss_sdr_tpu_torch.ops.cuda import epl_correlator as b5  # noqa: E402
from gnss_sdr_tpu_torch.receiver import tracking as trk  # noqa: E402

FS = 4_096_000.0
N0 = GPS_L1CA.samples_per_code(FS)
CODE_RATE = GPS_L1CA.code_rate_hz
IF = 100_000.0
N_EPOCHS = 40

INT_FIELDS = ("active", "prn_idx", "offset", "epochs", "lost_count",
              "carr_acc", "chip_int", "chip_frac_u32")
CLOSED_EXACT = ("active", "prn_idx", "offset", "epochs", "lost_count")
RATE_FIELDS = ("carr_freq", "code_rate")
TELEM_EXACT = ("processed", "locked", "lost_event", "start_offset",
               "epoch_index")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(name):
    """(track config kwargs, if_freq, signal, channel starts, n_epochs,
    valid_len); a start is (channel, prn, carrier Hz, offset)."""
    n = 48 * N0
    if name == "lost":
        rng = np.random.default_rng(0)
        sig = (0.01 * (rng.standard_normal(n)
                       + 1j * rng.standard_normal(n))).astype(np.complex64)
        return {}, 0.0, sig, [(0, 9, 1000.0, 0)], N_EPOCHS, None
    if_hz = IF if name == "costas_aided" else 0.0
    sats = [SatelliteScenario(prn=2, doppler_hz=3000.0),
            SatelliteScenario(prn=5, doppler_hz=-1500.0,
                              code_phase_chips=0.25),
            SatelliteScenario(prn=7, doppler_hz=700.0)]
    sig = synthesize(sats, n, FS, f_if_hz=if_hz, noise_std=0.3, seed=5)
    # the power scene pulls in from 50 Hz off; Costas lock, phase-
    # sensitive, starts 5 Hz off
    df = -50.0 if name in ("power", "tail") else -5.0
    starts = [(0, 2, if_hz + 3000.0 + df, 0), (2, 5, if_hz - 1500.0, 0),
              # deferred: its window never fits the block
              (3, 7, if_hz + 700.0, n - N0)]
    cfg_kw = {"power": {},
              "costas": dict(lock_mode="costas", interp_code=True),
              "costas_aided": dict(lock_mode="costas", carrier_aiding=True),
              "tail": {}}[name]
    valid = 30 * N0 + 100 if name == "tail" else None
    return cfg_kw, if_hz, sig, starts, N_EPOCHS, valid


def _run_both(correlator, scene):
    cfg_kw, if_hz, sig, starts, n_epochs, valid = _scene(scene)
    c = 4
    jcfg = JTrackConfig(n_channels=c, correlator=correlator, **cfg_kw)
    cfg = TrackConfig(n_channels=c, correlator=correlator, **cfg_kw)
    jparams = j_trk.TrackParams.create(jcfg, J_GPS, FS, if_freq_hz=if_hz)
    params = trk.TrackParams.create(cfg, GPS_L1CA, FS, if_freq_hz=if_hz)
    jst = j_trk.init_state(c)
    for ch, prn, f, off in starts:
        jst = j_trk.start_channel(jst, ch, prn - 1, f, off, CODE_RATE)
    st = trk.state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()})
    prn_rows = np.maximum(np.asarray(jst.prn_idx), 0)
    if correlator == "slice":
        table = trk.make_sampled_code_table(GPS_L1CA, FS, 32,
                                            window=params.window)
    else:
        table = trk.make_code_table(GPS_L1CA, 32)
    codes = table[prn_rows]
    re = np.real(sig).astype(np.float32)
    im = np.imag(sig).astype(np.float32)
    jv = None if valid is None else np.int32(valid)
    jcodes, codes = jnp.asarray(codes), torch.from_numpy(codes)
    b5.reset_launch_count()
    # open loop: one epoch at a time from the JAX state
    margins = {"rates": 0.0, "col_max": 0.0}
    j_state = jst
    for _ in range(n_epochs):
        j_next, j_row = j_trk.track_block(jparams, jcodes, j_state, re, im, 1,
                                          valid_len=jv)
        p_next, p_row = trk.track_block(
            params, codes, trk.state_from_numpy(
                {k: np.asarray(v) for k, v in j_state._asdict().items()}),
            re, im, 1, valid_len=valid)
        for k, v in check_against_jax(j_next, j_row, p_next, p_row,
                                      INT_FIELDS).items():
            margins[k] = max(margins[k], v)
        j_state = j_next
    # closed loop: the whole block from the common start
    jst2, jtl = j_trk.track_block(jparams, jcodes, jst, re, im, n_epochs,
                                  valid_len=jv)
    st2, tl = trk.track_block(params, codes, st, re, im, n_epochs,
                              valid_len=valid)
    closed = check_against_jax(jst2, jtl, st2, tl, CLOSED_EXACT)
    _phases_close(jst2, st2)
    assert b5.launch_count == 0          # CPU tensors: the plain version
    return margins, closed, st2, tl


def _phases_close(jst, st, tol=1e-4):
    """u32 carrier phase (cycles) and code phase (chips), circular."""
    d_carr = (np.asarray(jst.carr_acc).astype(np.int64)
              - st.carr_acc.astype(np.int64)) % 2 ** 32
    d_carr = np.minimum(d_carr, 2 ** 32 - d_carr) / 2 ** 32
    chips = lambda s: (np.asarray(s.chip_int).astype(np.float64)  # noqa: E731
                       + np.asarray(s.chip_frac_u32) / 2 ** 32)
    d_chip = np.abs(chips(jst) - chips(st)) % 1023
    d_chip = np.minimum(d_chip, 1023 - d_chip)
    assert d_carr.max() < tol and d_chip.max() < tol, (d_carr, d_chip)


def _close_to_col_max(name, a, b, tol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    rel = float(np.abs(a - b).max()) / scale
    assert rel < tol, f"{name}: {rel} of the column max"
    return rel


def _rates_close(name, a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ratio = float((np.abs(a - b) / (1e-3 + 1e-4 * np.abs(b))).max())
    assert ratio < 1.0, f"{name}: {ratio} x tol"
    return ratio


def check_against_jax(jst, jtl, st, tl, exact_fields):
    """The comparison of the module docstring (``exact_fields`` of the
    state equal); returns the margins."""
    for f in exact_fields:
        np.testing.assert_array_equal(getattr(st, f),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    for f in TELEM_EXACT:
        np.testing.assert_array_equal(getattr(tl, f),
                                      np.asarray(getattr(jtl, f)), err_msg=f)
    margins = {"rates": 0.0, "col_max": 0.0}
    for f in RATE_FIELDS:
        margins["rates"] = max(
            margins["rates"],
            _rates_close(f, getattr(st, f), getattr(jst, f)),
            _rates_close("telem " + f, getattr(tl, f), getattr(jtl, f)))
    for f in ("carr_err", "code_err", "lock_ema"):
        margins["col_max"] = max(margins["col_max"], _close_to_col_max(
            f, getattr(st, f), getattr(jst, f)))
    for f in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "power", "pll_err",
              "dll_err", "chip_phase"):
        margins["col_max"] = max(margins["col_max"], _close_to_col_max(
            f, getattr(tl, f), getattr(jtl, f)))
    return margins


@pytest.mark.parametrize("scene", ["power", "costas", "costas_aided",
                                   "tail", "lost"])
@pytest.mark.parametrize("correlator", ["shift", "exact", "slice", "pallas"])
def test_track_block_matches_jax(correlator, scene):
    margins, closed, st, tl = _run_both(correlator, scene)
    print(f"\n{correlator}/{scene}: open-loop margins {margins}, "
          f"closed-loop {closed}")
    proc = tl.processed
    if scene == "lost":
        assert tl.lost_event.sum() == 1 and not st.active[0]
    else:
        assert proc[:, 0].all() or scene == "tail"
        assert not proc[:, 1].any() and not proc[:, 3].any()  # idle, deferred
        assert tl.locked[proc[:, 0], 0].all()
    if scene == "tail":
        # the tail of the valid samples ends the processing early
        assert 0 < proc[:, 0].sum() < N_EPOCHS


def test_unknown_correlator_raises():
    cfg = TrackConfig(n_channels=1, correlator="bogus")
    params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
    x = np.zeros(4 * N0, np.float32)
    with pytest.raises(ValueError, match="correlator"):
        trk.track_block(params, trk.make_code_table(GPS_L1CA, 1),
                        trk.init_state(1), x, x, 2)
