"""The port receiver's stages on the CPU (``utils/profiling.StageTimer``):
the tracking stage split into its sub-steps on both trackers' single
blocks (``track.anchor`` on the fused tracker, ``track.launch``,
``track.wait``, ``track.absorb``), the host stages ``window`` and
``lifecycle``, ``nav.sync`` inside ``nav``; each stage a profiler range
named after the receiver's signal while a profiler records (a user
annotation, as ``torch.profiler.record_function`` makes), and none opened
while none does."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gnss_sdr_tpu_torch import (  # noqa: E402
    AcqConfig, ReceiverConfig, RfConfig, TrackConfig, presets)
from gnss_sdr_tpu_torch.models import SatelliteScenario  # noqa: E402
from gnss_sdr_tpu_torch.receiver import (  # noqa: E402
    MultiConstellationReceiver, Receiver, SyntheticSource)
from gnss_sdr_tpu_torch.utils import profiling  # noqa: E402

FS = 2_046_000.0
SATS = [dict(prn=5, doppler_hz=2100.0, amplitude=0.35),
        dict(prn=9, doppler_hz=-1500.0, amplitude=0.35)]
N_BLOCKS = 12
TRACK_SUBS = ("track.launch", "track.wait", "track.absorb")
TRACKERS = {"scanned": dict(),
            "fused": dict(correlator="fused", fused_layout="direct")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _receiver(tracker: str) -> Receiver:
    return Receiver(
        ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
            acq=AcqConfig(steady_threshold=2),
            track=TrackConfig(n_channels=4, **TRACKERS[tracker]),
            block_ms=20),
        SyntheticSource([SatelliteScenario(**s) for s in SATS], FS,
                        noise_std=1.0, seed=13), device="cpu")


@pytest.fixture(scope="module", params=sorted(TRACKERS))
def ran(request):
    rx = _receiver(request.param)
    summary = rx.run(max_blocks=N_BLOCKS)
    assert summary["tracked_prns"] == [5, 9]
    return request.param, rx


def test_every_stage_in_stats(ran):
    tracker, rx = ran
    want = {"ingest", "window", "acquire", "lifecycle", "track", "nav",
            "nav.sync", *TRACK_SUBS}
    if tracker == "fused":
        want.add("track.anchor")
        assert rx.fused is not None and rx.fused.timers is rx.timers
    else:
        assert rx.fused is None
    assert want <= set(rx.timers.stats)
    assert ("track.anchor" in rx.timers.stats) == (tracker == "fused")
    assert rx.nav.timers is rx.timers
    st = rx.timers.stats
    # one of each per block, two launch entries (the receiver's replica
    # rows, then the tracker's launch), two lifecycle entries (the search
    # mode before the search, the rest after nav)
    assert st["window"].calls == st["track"].calls == N_BLOCKS
    assert st["track.wait"].calls == st["track.absorb"].calls == N_BLOCKS
    assert st["track.launch"].calls == 2 * N_BLOCKS
    assert st["lifecycle"].calls == 2 * N_BLOCKS
    assert st["nav.sync"].calls == st["nav"].calls == N_BLOCKS


def test_sub_stages_within_their_parents(ran):
    tracker, rx = ran
    st = rx.timers.stats
    for name, s in st.items():
        if "." in name:
            parent = name.rsplit(".", 1)[0]
            assert s.total_s <= st[parent].total_s, (name, parent)
    subs = TRACK_SUBS + (("track.anchor",) if tracker == "fused" else ())
    assert sum(st[k].total_s for k in subs) >= 0.9 * st["track"].total_s


def test_summary_has_no_track_realtime_factor(ran):
    _, rx = ran
    s = rx.summary()
    assert "track_realtime_factor" not in s
    assert not hasattr(rx.timers, "realtime_factor")
    assert {"window", "lifecycle", "track.wait"} <= set(s["stage_timing"])


def _chrome_events(log_dir) -> list:
    (path,) = list(log_dir.glob("trace_*.json"))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


@pytest.mark.parametrize("tracker", sorted(TRACKERS))
def test_trace_nests_track_wait_in_track(tracker, tmp_path):
    rx = _receiver(tracker)
    rx.run(max_blocks=4)
    with profiling.trace(str(tmp_path)):
        rx.run(max_blocks=2)
    ev = _chrome_events(tmp_path)
    tracks = [e for e in ev if e["name"] == "stage.gps_l1ca.track"]
    waits = [e for e in ev if e["name"] == "stage.gps_l1ca.track.wait"]
    assert len(tracks) == len(waits) == 2
    for w in waits:
        assert w.get("cat") == "user_annotation"
        assert any(t["tid"] == w["tid"] and t["ts"] <= w["ts"]
                   and w["ts"] + w["dur"] <= t["ts"] + t["dur"]
                   for t in tracks)
    names = {e["name"] for e in ev if e["name"].startswith("stage.")}
    for stage in ("ingest", "window", "lifecycle", "nav", "nav.sync",
                  *TRACK_SUBS):
        assert f"stage.gps_l1ca.{stage}" in names, stage


def test_no_range_opened_without_a_profiler(monkeypatch, tmp_path):
    entered = []
    real = profiling._range_enter

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_range_enter", counting)
    rx = _receiver("fused")
    rx.run(max_blocks=4)
    assert rx.timers.stats["track.anchor"].calls == 4
    assert entered == []
    # the same receiver under a profiler opens them, through the patch
    with profiling.trace(str(tmp_path)):
        rx.run(max_blocks=1)
    assert "stage.gps_l1ca.track.anchor" in entered


def test_stage_timer_prefix_and_sub_stage_accounting():
    t = profiling.StageTimer("galileo_e1b")
    with t.stage("track", 10):
        with t.stage("track.wait"):
            pass
    assert t.prefix == "galileo_e1b"
    assert t.stats["track"].calls == t.stats["track.wait"].calls == 1
    assert t.stats["track"].items == 10
    assert t.stats["track.wait"].total_s <= t.stats["track"].total_s
    with pytest.raises(ValueError):
        with t.stage("nav"):
            raise ValueError("a stage closes on an exception")
    assert t.stats["nav"].calls == 1


def test_multi_receiver_branches_name_their_own_ranges(tmp_path):
    configs = presets.ladder4_multi_constellation()
    fs = 8_184_000.0
    src = SyntheticSource([], fs, noise_std=1.0, seed=3)
    mrx = MultiConstellationReceiver(configs, src, device="cpu")
    assert {name: rx.timers.prefix for name, rx in mrx.receivers.items()
            } == {name: name for name in configs}
    for rx in mrx.receivers.values():
        assert rx.nav.timers is rx.timers
    # two branches traced over one block each: every range carries its
    # own branch's signal
    two = {k: configs[k] for k in ("gps_l1ca", "galileo_e1b")}
    mrx = MultiConstellationReceiver(
        two, SyntheticSource([], fs, noise_std=1.0, seed=3), device="cpu")
    with profiling.trace(str(tmp_path)):
        mrx.run(max_blocks=1)
    names = {e["name"] for e in _chrome_events(tmp_path)
             if e["name"].startswith("stage.")}
    for branch in two:
        for stage in ("ingest", "window", "track", "track.wait", "nav"):
            assert f"stage.{branch}.{stage}" in names, (branch, stage)
    assert all(n.split(".")[1] in two for n in names), names
    assert np.all([rx.timers.stats["track"].calls == 1
                   for rx in mrx.receivers.values()])


def test_nav_sync_times_the_chains_not_yet_synced():
    """Two BeiDou D1 channels over 2 s: one on clean NH-coded 20 ms
    bits (it bit-syncs), one on noise (it never does, as a false lock).
    The noise channel's feed runs inside ``nav.sync`` every block; the
    other's outside it once synced."""
    from gnss_sdr_tpu_torch.nav.bds_d1 import NH
    from gnss_sdr_tpu_torch.receiver.navproc import NavProcessor

    class Recording(profiling.StageTimer):
        """A StageTimer that keeps the names of its open stages."""

        def __init__(self):
            super().__init__("beidou_b1i")
            self.open = []

        def stage(self, name, items=0.0):
            inner, opened = super().stage(name, items), self.open

            class _Rec:
                def __enter__(self):
                    opened.append(name)
                    return inner.__enter__()

                def __exit__(self, *exc):
                    opened.pop()
                    return inner.__exit__(*exc)
            return _Rec()

    t = Recording()
    nav = NavProcessor(FS, 1e-3, 2046, signal="beidou_b1i", timers=t)
    nav.open_channel(0, 6)
    nav.open_channel(1, 27)
    inside = {0: [], 1: []}
    for ch, chan in nav.channels.items():
        def spy(*a, ch=ch, feed=chan.feed_array):
            inside[ch].append("nav.sync" in t.open)
            return feed(*a)
        chan.feed_array = spy
    rng = np.random.default_rng(1)
    chips = (np.repeat(rng.choice([-1.0, 1.0], 100), 20)
             * np.tile(np.asarray(NH, np.float64), 100))    # 2 s
    t_epochs, n_blocks = 20, 100
    for b in range(n_blocks):
        e = np.arange(b * t_epochs, (b + 1) * t_epochs)
        i_p = np.stack([chips[e] * 50.0, rng.normal(0, 50.0, t_epochs)],
                       axis=1).astype(np.float32)
        telem = type("Telem", (), dict(
            processed=np.ones((t_epochs, 2), bool), i_p=i_p,
            epoch_index=np.stack([e, e], axis=1).astype(np.int32),
            start_offset=np.zeros((t_epochs, 2), np.int32),
            chip_phase=np.zeros((t_epochs, 2), np.float32),
            carr_freq=np.zeros((t_epochs, 2), np.float32)))
        nav.feed_block(telem, b * 40_920)
    assert nav.channels[0].chain.synced
    assert not nav.channels[1].chain.synced
    assert all(inside[1]) and len(inside[1]) == n_blocks
    assert inside[0][0] and not inside[0][-1]
    assert t.stats["nav.sync"].calls == n_blocks
    assert t.open == []
