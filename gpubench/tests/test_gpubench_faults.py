"""A run with the timed path broken underneath reads ``correct`` false:
the harness's look for a card skipped, the rest of a run driven on the
CPU (the kernels' plain versions) with one fault planted in the port:
a tracking step that returns its state unchanged, half of the channels'
correlations left out, an acquisition answer and a correlation altered
where they are produced; and ``carrier_truth_hz`` over its limit where
a loop is frozen at a handoff 100 Hz off or a carrier walks a few Hz a
block. (The cells run on one card: no exchange between cards to leave
out.)"""
import io

import numpy as np

from gpubench.harness import spec
from gpubench.harness.entry import execute

BENCH = spec.load_benchmark()


def _correct(cell="rtlsdr.open_sky", seconds=0.6):
    r = execute(BENCH, cell, 1234567, seconds, False, device="cpu",
                out=io.StringIO(), err=io.StringIO())
    return r["correct"], {k: v["value"] for k, v in r["compared"].items()}


def _scanned_fault(monkeypatch, fault):
    from gnss_sdr_tpu_torch.receiver import tracking

    orig = tracking.track_block

    def broken(params, codes, state, *a, **kw):
        st, telem = orig(params, codes, state, *a, **kw)
        return fault(state, st, telem)
    monkeypatch.setattr(tracking, "track_block", broken)


def _short_pull_in(monkeypatch, after_s=0.3):
    """``carrier_truth_hz`` from channels tracked ``after_s``: what a
    short run on the CPU holds (the cells leave 2 s for the pull-in)."""
    orig = spec.load_traffic

    def load(name, bench_dir=spec.BENCH_DIR):
        t = orig(name, bench_dir)
        t["check"]["truth_after_s"] = after_s
        return t
    monkeypatch.setattr(spec, "load_traffic", load)


TRUTH_LIMIT = spec.load_config(BENCH, "gps_l1_rtlsdr")["limits"][
    "carrier_truth_hz"]
# a window long enough, on a loaded CPU too, for channels tracked past
# ``_short_pull_in``'s time in the sampled blocks
TRUTH_SECONDS = 2.0


def test_sound_run_is_correct():
    ok, numbers = _correct()
    assert ok, numbers


def test_state_returned_unchanged(monkeypatch):
    _scanned_fault(monkeypatch, lambda old, new, telem: (old, telem))
    ok, numbers = _correct()
    assert not ok and numbers["track_gap"] == 1.0


def test_half_the_channels_left_out(monkeypatch):
    def fault(old, new, telem):
        c = telem.i_p.shape[1] // 2
        t = telem._asdict()
        for f in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l"):
            t[f] = t[f].copy()
            t[f][:, c:] = 0.0
        return new, type(telem)(**t)
    _scanned_fault(monkeypatch, fault)
    ok, numbers = _correct()
    assert not ok and numbers["track_gap"] > 0.3


def test_correlation_altered(monkeypatch):
    def fault(old, new, telem):
        t = telem._asdict()
        t["i_p"] = t["i_p"].copy()
        t["i_p"][40, 0] *= -1.0
        return new, type(telem)(**t)
    _scanned_fault(monkeypatch, fault)
    ok, numbers = _correct()
    assert not ok and numbers["track_gap"] > 1.0


def test_sound_carriers_within_the_truth_limit(monkeypatch):
    _short_pull_in(monkeypatch)
    ok, numbers = _correct(seconds=TRUTH_SECONDS)
    assert ok and 0.0 < numbers["carrier_truth_hz"] < TRUTH_LIMIT, numbers


def test_loop_frozen_at_a_handoff_100_hz_off(monkeypatch):
    """Every handoff 100 Hz off its search's answer, and the carrier
    loop never moves from it."""
    from gnss_sdr_tpu_torch.receiver.acquisition import AcquisitionEngine

    search = AcquisitionEngine.search

    def off(self, *a, **kw):
        cands = search(self, *a, **kw)
        for c in cands:
            c.carrier_freq_hz += 100.0
        return cands
    monkeypatch.setattr(AcquisitionEngine, "search", off)

    def fault(old, new, telem):
        held = np.broadcast_to(old.carr_freq, telem.carr_freq.shape)
        return (new._replace(carr_freq=old.carr_freq.copy(),
                             carr_err=old.carr_err.copy()),
                telem._replace(carr_freq=held.astype(np.float32)))
    _scanned_fault(monkeypatch, fault)
    _short_pull_in(monkeypatch)
    ok, numbers = _correct(seconds=TRUTH_SECONDS)
    assert not ok and numbers["carrier_truth_hz"] > TRUTH_LIMIT, numbers


def test_carrier_walks_a_few_hz_a_block(monkeypatch):
    """The carrier NCO runs a walk of 10 Hz a block above the frequency
    the tracker reports and keeps: the loops hold the signal, and the
    reported carrier walks off the satellite's."""
    from gnss_sdr_tpu_torch.receiver import tracking

    orig = tracking.track_block
    walk = [0.0]

    def broken(params, codes, state, *a, **kw):
        walk[0] += 10.0
        w = np.float32(walk[0])
        st, telem = orig(params, codes, state._replace(
            carr_freq=state.carr_freq + w), *a, **kw)
        return (st._replace(carr_freq=st.carr_freq - w),
                telem._replace(carr_freq=telem.carr_freq - w))
    monkeypatch.setattr(tracking, "track_block", broken)
    _short_pull_in(monkeypatch)
    ok, numbers = _correct(seconds=TRUTH_SECONDS)
    assert not ok and numbers["carrier_truth_hz"] > TRUTH_LIMIT, numbers


def test_acquisition_answer_altered(monkeypatch):
    from gnss_sdr_tpu_torch.receiver.acquisition import AcquisitionEngine

    orig = AcquisitionEngine.search

    def broken(self, *a, **kw):
        cands = orig(self, *a, **kw)
        if cands:
            cands[0].code_phase_samples += 1
        return cands
    monkeypatch.setattr(AcquisitionEngine, "search", broken)
    ok, numbers = _correct()
    assert not ok and numbers["acq_gap"] == 1.0


def test_fused_state_returned_unchanged(monkeypatch):
    from gnss_sdr_tpu_torch.receiver.fused_runner import FusedTracker

    orig = FusedTracker.run_block

    def broken(self, state, *a, **kw):
        _, telem = orig(self, state, *a, **kw)
        return state, telem
    monkeypatch.setattr(FusedTracker, "run_block", broken)
    ok, numbers = _correct("ladder4.sparse_sky", 0.3)
    assert not ok and numbers["track_gap"] == 1.0


def _fused_telemetry_fault(monkeypatch, fault):
    """``fault(telem dict)`` applied to every block of more than one
    superstep (B1's branches), after superstep 0, where the fused
    tracker hands its telemetry on; the ledger is the program's own."""
    from gnss_sdr_tpu_torch.receiver.fused_runner import FusedTracker

    orig = FusedTracker.run_block

    def broken(self, state, *a, **kw):
        st, telem = orig(self, state, *a, **kw)
        if telem.i_p.shape[0] < 10:
            return st, telem
        t = {k: np.array(v, copy=True) for k, v in telem._asdict().items()}
        fault(t)
        return st, type(telem)(**t)
    monkeypatch.setattr(FusedTracker, "run_block", broken)


def test_fused_correlation_altered_after_superstep_0(monkeypatch):
    def fault(t):
        t["i_p"][7] *= -1.0                   # superstep 1 of 4 (K = 5)
    _fused_telemetry_fault(monkeypatch, fault)
    ok, numbers = _correct("ladder4.sparse_sky", 0.3)
    assert not ok and numbers["track_gap"] > 1.0


def test_fused_lock_lost_after_superstep_0(monkeypatch):
    """Supersteps 1-3 report no correlation and no lock while the
    ledger carries on as the program left it."""
    def fault(t):
        for f in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "power"):
            t[f][5:] = 0.0
        t["locked"][5:] = False
    _fused_telemetry_fault(monkeypatch, fault)
    ok, numbers = _correct("ladder4.sparse_sky", 0.3)
    assert not ok and numbers["track_gap"] == 1.0


def test_nav_units_altered():
    """A decoded unit altered where the decoder produces it reads wrong,
    the broadcast one right, for each system's message."""
    from gpubench.harness import checks
    from gpubench.signals import SIGNALS, beidou_b1i, glonass_l1of

    rng = np.random.default_rng(0)
    streams = {n: SIGNALS[n].nav(9, 3, rng) for n in SIGNALS}

    class Sf:                                   # an LNAV subframe
        def __init__(self, s, tow_off=0):
            sf_id, tow, words = streams["gps_l1ca"].subframe(s)
            self.subframe_id, self.tow_counts = sf_id, tow + tow_off
            self.data = np.vstack([np.zeros((2, 24), np.uint8), words])

    class Word:                                 # an I/NAV word
        def __init__(self, k, flip=False):
            self.data = streams["galileo_e1b"].word(k).copy()
            self.data[40] ^= flip

    b = streams["beidou_b1i"]
    fra, sow, raw = next(b.subframe(k) for k in range(5)
                         if b.subframe(k)[0] <= 3)
    good_b = (fra, sow, beidou_b1i.fields_of(fra, raw), 0)
    bad_raw = raw.copy()
    bad_raw[5] ^= 1
    g = streams["glonass_l1of"]
    m, graw = g.string(1)
    cases = {
        "gps_l1ca": ([Sf(4)], [Sf(4, tow_off=1)]),
        "galileo_e1b": ([Word(3)], [Word(3, flip=True)]),
        "beidou_b1i": ([good_b],
                       [(fra, sow, beidou_b1i.fields_of(fra, bad_raw), 0)]),
        "glonass_l1of": ([(m, glonass_l1of.fields_of(m, graw))],
                         [(m % 15 + 1, glonass_l1of.fields_of(m, graw))]),
    }
    for name, (good, bad) in cases.items():
        assert checks._wrong(name, good, streams[name], 30.0) == 0, name
        assert checks._wrong(name, bad, streams[name], 30.0) == 1, name


def test_nav_missing_counts_a_silent_channel_but_in_skipped_branches():
    """A channel tracked past ``nav_min_s`` with nothing decoded counts
    once, except in a branch that ``nav_missing_skip`` names."""
    from types import SimpleNamespace as NS

    from gpubench.harness import checks

    def branch():
        chain = NS(frames=NS(subframes=[]))
        nav = NS(channels={0: NS(prn=7, chain=chain, subframe_count=0)},
                 ephemerides={})
        log = NS(traces={0: NS(i_p=np.zeros(30_000))})
        return NS(nav=nav, telemetry=log, source=NS(pos=8_184_000))

    def run(skip):
        config = {"stream": {"fs_hz": 8_184_000.0}}
        if skip:
            config["nav_missing_skip"] = ["gps_l1ca"]
        return NS(sky=[NS(system="gps_l1ca", prn=7, nav=NS())],
                  config=config, branches={"gps_l1ca": branch()})

    assert checks.check_nav(run(False), 24.0)[1] == 1
    assert checks.check_nav(run(True), 24.0)[1] == 0
