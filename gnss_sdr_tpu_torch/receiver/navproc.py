"""Per-channel navigation processing attached to the receiver.

Completes the full-receiver chain (BASELINE.md config 5): prompt-I
telemetry -> bit sync -> frame sync -> subframes -> ephemeris + TOW ->
pseudoranges -> PVT. Runs host-side over the telemetry the device
pipeline emits (SURVEY.md section 7: bit-level decoding stays off the
accelerator).

Time bookkeeping: each decoded subframe pins one (epoch, global_sample)
pair to GPS time — the HOW TOW is the time of the *next* subframe start
(IS-GPS-200 20.3.3.2), so the pinned subframe started at tow_s - 6.
From that anchor, any later epoch's transmit time follows by counting
code periods; receiver time for the same epoch is global_sample / fs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .. import constants as C
from ..nav.bits import BitSynchronizer, FrameDecoder, Subframe
from ..nav.ephemeris import Ephemeris, EphemerisAssembler
from ..nav.pvt import PvtSolution, solve_pvt, solve_velocity
from ..utils.profiling import StageTimer


@dataclasses.dataclass
class AnchorEvent:
    """A decoded time mark: transmit time ``tow_s`` (seconds of the
    constellation's week) at the start of tracking epoch ``epoch``."""

    epoch: int
    tow_s: float
    payload: object = None      # Subframe / InavWord / ... (diagnostics)


class GpsLnavChain:
    """GPS L1 C/A: 20 ms bit sync -> LNAV frames -> ephemeris."""

    signal = "gps_l1ca"

    def __init__(self, prn: int):
        self.prn = prn
        self.bit_sync = BitSynchronizer()
        self.frames = FrameDecoder()
        self.assembler = EphemerisAssembler()
        self.count = 0
        self.ephemeris: Optional[Ephemeris] = None

    #: bits without a verified double-preamble, counted since the frame
    #: decoder was built or last dropped its lock, before declaring the
    #: bit-sync phase wrong and rebuilding it: a correct phase locks
    #: within ~616 bits (one partial + one full subframe + preamble)
    RESYNC_BITS = 650

    def feed_array(self, i_prompts, epochs) -> list[AnchorEvent]:
        events = []
        for bit, _ in self.bit_sync.feed_array(i_prompts, epochs):
            sf = self.frames.feed(bit)
            if sf is None:
                continue
            self.count += 1
            sf_epoch = self.bit_sync.bit_epochs[sf.first_bit_index]
            eph = self.assembler.feed(self.prn, sf)
            if eph is not None:
                self.ephemeris = eph
            # HOW TOW marks the NEXT subframe start (IS-GPS-200
            # 20.3.3.2): this subframe's first bit sits at tow - 6 s
            events.append(AnchorEvent(epoch=sf_epoch,
                                      tow_s=sf.tow_s - 6.0, payload=sf))
        if (not self.frames.frame_locked
                and len(self.frames.bits) - self.frames.unlocked_at
                > self.RESYNC_BITS):
            # anti-stuck resync: a bit-sync boundary captured from the
            # pull-in transient's rotating prompts is otherwise
            # PERMANENT (BitSynchronizer.synced never re-evaluates) and
            # every 20 ms integration straddles real bit edges, so the
            # preamble can never verify (observed: 2 of 6 channels on
            # the live TTFF scene, bit_synced w/ 0 subframes). Rebuild
            # sync from the now-converged prompts; frame state restarts
            # clean (subframe count survives on self.count). Gated on
            # the bits since the last unlock, not on all buffered bits,
            # so a dropped lock first re-locks from the buffer (C2).
            self.bit_sync = BitSynchronizer()
            self.frames = FrameDecoder()
        return events

    @property
    def synced(self) -> bool:
        """Whether the 20 ms bit grid is found."""
        return self.bit_sync.synced

    def status(self) -> dict:
        return {
            "bit_synced": self.bit_sync.synced,
            "frame_locked": self.frames.frame_locked,
            "subframes": self.count,
        }


class GalileoInavChain:
    """Galileo E1B: one symbol per 4 ms epoch -> I/NAV pages -> words."""

    signal = "galileo_e1b"

    def __init__(self, prn: int):
        from ..nav.inav import InavDecoder

        self.prn = prn
        self.dec = InavDecoder(prn)
        self._last_gst_id = None

    @property
    def ephemeris(self):
        return self.dec.ephemeris

    @property
    def count(self) -> int:
        return self.dec.word_count

    @property
    def synced(self) -> bool:
        """Whether the page sync (the decoder's _try_sync) is found."""
        return self.dec.synced

    def feed_array(self, i_prompts, epochs) -> list[AnchorEvent]:
        words = self.dec.feed_array(i_prompts, epochs)
        events = []
        for w in words:
            if w.word_type != 5 or w.even_page_epoch is None:
                continue
            g = self.dec.assembler.gst
            if g is None or g.even_page_index != w.even_page_index:
                continue
            events.append(AnchorEvent(epoch=w.even_page_epoch,
                                      tow_s=g.tow_s, payload=w))
        return events

    def status(self) -> dict:
        return {
            "bit_synced": self.dec.synced,
            "frame_locked": self.dec.frame_locked,
            "subframes": self.dec.word_count,
        }


def make_chain(signal: str, prn: int):
    """Per-signal decode chain factory."""
    if signal == "gps_l1ca":
        return GpsLnavChain(prn)
    if signal in ("galileo_e1b", "galileo_e1c"):
        # E1C is the pilot (no data); decode chain applies to E1B
        return GalileoInavChain(prn)
    if signal == "beidou_b1i":
        from ..nav.bds_d1 import BdsD1Chain

        return BdsD1Chain(prn)
    if signal == "glonass_l1of":
        from ..nav.glonass_nav import GlonassNavChain

        return GlonassNavChain(prn)
    raise KeyError(f"no nav decode chain for signal {signal!r}")


@dataclasses.dataclass
class TimeAnchor:
    """GPS-time pin: the anchor epoch's window-start sample carries
    transmit time ``tow_s`` (s of week); ``chip_phase`` is the tracked
    code phase (chips) at that sample, so later epochs' transmit times
    follow chip-exactly:

      t_tx(e) = tow_s + ((e - epoch) * L + wrap(cp_e - chip_phase)) / rate
    """

    epoch: int
    global_sample: int
    tow_s: float
    chip_phase: float = 0.0


class ChannelNav:
    """One channel's decoding chain (reference capability:
    src/decoding.rs NavSyncStatus, properly implemented)."""

    #: epoch-history ring capacity (epochs); ~8 s at 1 ms epochs
    HIST_CAP = 8192

    def __init__(self, prn: int, code_period_s: float = 1e-3,
                 code_length: int = 1023, signal: str = "gps_l1ca"):
        self.prn = prn
        self.signal = signal
        self.code_period_s = code_period_s
        self.code_length = code_length
        self.code_rate = code_length / code_period_s
        self.chain = make_chain(signal, prn)
        self.anchor: Optional[TimeAnchor] = None
        # epoch -> (global_sample, chip_phase, carr_freq) history as a
        # numpy ring keyed by epoch % HIST_CAP (a python dict updated
        # per epoch measured ~28 ms per 500 ms block at 24 channels —
        # the single largest host cost in the streaming receiver)
        cap = self.HIST_CAP
        self._h_stamp = np.full(cap, -1, np.int64)
        self._h_g = np.zeros(cap, np.int64)
        self._h_cp = np.zeros(cap, np.float64)
        self._h_cf = np.zeros(cap, np.float64)

    # -- epoch-history ring -------------------------------------------
    def _hist_put(self, epochs, global_samples, chip_phases, carr_freqs):
        e = np.asarray(epochs, np.int64)
        idx = e % self.HIST_CAP
        self._h_stamp[idx] = e
        self._h_g[idx] = np.asarray(global_samples, np.int64)
        self._h_cp[idx] = np.asarray(chip_phases, np.float64)
        self._h_cf[idx] = np.asarray(carr_freqs, np.float64)

    def _hist_get(self, epoch: int, default=None):
        i = int(epoch) % self.HIST_CAP
        if self._h_stamp[i] != epoch:
            return default
        return (int(self._h_g[i]), float(self._h_cp[i]),
                float(self._h_cf[i]))

    def _hist_epochs(self) -> np.ndarray:
        """Valid epochs currently held, ascending."""
        return np.sort(self._h_stamp[self._h_stamp >= 0])

    def history(self) -> dict[int, tuple[int, float, float]]:
        """Dict view of the epoch history (tests/diagnostics)."""
        valid = self._h_stamp >= 0
        return {
            int(e): (int(g), float(c), float(f))
            for e, g, c, f in zip(
                self._h_stamp[valid], self._h_g[valid],
                self._h_cp[valid], self._h_cf[valid])
        }

    # GPS-chain aliases (tests/diagnostics reach for these). Live
    # properties, not init-time copies: the chain may REPLACE its
    # sync/frame objects on an anti-stuck resync.
    @property
    def bit_sync(self):
        return getattr(self.chain, "bit_sync", None)

    @property
    def frames(self):
        return getattr(self.chain, "frames", None)

    @property
    def subframe_count(self) -> int:
        return self.chain.count

    def feed_epoch(self, i_prompt: float, epoch: int,
                   global_sample: int,
                   chip_phase: float = 0.0,
                   carr_freq: float = 0.0) -> Optional[object]:
        """Single-epoch convenience wrapper over feed_array."""
        evs = self.feed_array([i_prompt], [epoch], [global_sample],
                              [chip_phase], [carr_freq])
        return evs[-1].payload if evs else None

    def feed_array(self, i_prompts, epochs, global_samples,
                   chip_phases, carr_freqs) -> list[AnchorEvent]:
        """Vectorized feed of one block's processed epochs for this
        channel (the decode chain is numpy-vectorized; the rare
        completed frames stay in python). Returns anchor events."""
        self._hist_put(epochs, global_samples, chip_phases, carr_freqs)
        g_last = int(global_samples[-1]) if len(global_samples) else 0
        events = self.chain.feed_array(i_prompts, epochs)
        for ev in events:
            g0, cp0, _ = self._hist_get(ev.epoch, (g_last, 0.0, 0.0))
            cp0_signed = cp0 if cp0 < self.code_length / 2 \
                else cp0 - self.code_length
            # the decoded time mark stamps a code-epoch boundary; the
            # anchor epoch's window-start sample sits cp0 chips past it
            self.anchor = TimeAnchor(
                epoch=ev.epoch,
                global_sample=g0,
                tow_s=ev.tow_s + cp0_signed / self.code_rate,
                chip_phase=cp0,
            )
        return events

    def smoothed_transmit_time(
        self, epoch: int, fs_hz: float, f_if_hz: float,
        carrier_freq_hz: float, window: int = 100,
    ) -> Optional[float]:
        """Carrier-smoothed (Hatch) transmit time at ``epoch``.

        Code observables carry noise/quantization wander; the carrier
        predicts the transmit-time ADVANCE between epochs almost
        noiselessly (dt_tx = dt_rx * (1 + fd/f_carrier)). Averaging
        code-derived t_tx(k) propagated to the latest epoch by the
        carrier smooths uncorrelated code noise by ~window.

        Note: on floor-quantized synthetic scenes the code wander is
        strongly time-correlated (it drifts with the code-Doppler
        sample-phase), so smoothing does NOT help there — it pays off
        on band-limited real RF where code noise decorrelates
        epoch-to-epoch. Default off in compute_pvt."""
        latest = self._hist_get(epoch)
        if self.anchor is None or latest is None:
            return None
        g_n = latest[0]
        valid = self._h_stamp >= 0
        ks = self._h_stamp[valid]
        sel = ks <= epoch
        order = np.argsort(ks[sel])[-window:]
        idx = (ks[sel][order]) % self.HIST_CAP
        k_arr = self._h_stamp[idx].astype(np.float64)
        g_k = self._h_g[idx].astype(np.float64)
        cp_k = self._h_cp[idx]
        f_k = self._h_cf[idx]
        # vectorized transmit_time_at(k, cp_k)
        base = (self.anchor.tow_s
                + (k_arr - self.anchor.epoch) * self.code_period_s)
        half = self.code_length / 2
        d = (cp_k - self.anchor.chip_phase + half) % self.code_length - half
        t_k = base + d / self.code_rate
        fd = f_k - f_if_hz
        vals = t_k + (g_n - g_k) / fs_hz * (1.0 + fd / carrier_freq_hz)
        if vals.size == 0:
            return None
        return float(np.mean(vals))

    def transmit_time_at(self, epoch: int,
                         chip_phase: Optional[float] = None) -> Optional[float]:
        """GPS transmit time (s of week) of the given epoch's
        window-start sample, chip-exact when ``chip_phase`` is given."""
        if self.anchor is None:
            return None
        base = (
            self.anchor.tow_s
            + (epoch - self.anchor.epoch) * self.code_period_s
        )
        if chip_phase is None:
            return base
        # signed wrap of the chip-phase drift since the anchor
        d = chip_phase - self.anchor.chip_phase
        half = self.code_length / 2
        d = (d + half) % self.code_length - half
        return base + d / self.code_rate


class NavProcessor:
    """All channels' nav chains + ephemeris store + PVT.

    ``timers``: the receiver's StageTimer, in which feed_block times the
    feed of the channels whose chain has not synced yet (``nav.sync``,
    inside the receiver's ``nav`` stage): what a channel that never
    syncs, such as a false lock, costs the host."""

    def __init__(self, fs_hz: float, code_period_s: float = 1e-3,
                 code_length: int = 1023, signal: str = "gps_l1ca",
                 timers: StageTimer | None = None):
        self.timers = timers if timers is not None else StageTimer()
        self.fs = fs_hz
        self.code_period_s = code_period_s
        self.code_length = code_length
        self.signal = signal
        self.channels: dict[int, ChannelNav] = {}
        self.ephemerides: dict[int, Ephemeris] = {}
        # per channel: latest (epoch, global_sample, chip_phase), for PVT
        self.latest: dict[int, tuple[int, int, float]] = {}

    def open_channel(self, channel: int, prn: int) -> None:
        self.channels[channel] = ChannelNav(
            prn, self.code_period_s, self.code_length, self.signal
        )

    def close_channel(self, channel: int) -> None:
        self.channels.pop(channel, None)

    def feed_block(self, telem, window_global_start: int) -> None:
        """Feed one block's processed epochs to every channel's chain;
        the chains that have not synced yet are fed last, under
        ``nav.sync`` (entered every block, so that it reads 0 where
        every chain has synced)."""
        processed = np.asarray(telem.processed)
        i_p = np.asarray(telem.i_p)
        epochs = np.asarray(telem.epoch_index)
        offsets = np.asarray(telem.start_offset)
        chips = np.asarray(telem.chip_phase)
        carr = np.asarray(telem.carr_freq)

        def feed(ch, nav):
            rows = np.where(processed[:, ch])[0]
            if rows.size == 0:
                return
            g_rows = window_global_start + offsets[rows, ch].astype(
                np.int64)
            e_rows = epochs[rows, ch]
            cp_rows = chips[rows, ch]
            nav.feed_array(i_p[rows, ch], e_rows, g_rows,
                           cp_rows, carr[rows, ch])
            eph = nav.chain.ephemeris
            if eph is not None:
                self.ephemerides[nav.prn] = eph
            self.latest[ch] = (int(e_rows[-1]), int(g_rows[-1]),
                               float(cp_rows[-1]))

        unsynced = []
        for ch, nav in self.channels.items():
            if nav.chain.synced:
                feed(ch, nav)
            else:
                unsynced.append((ch, nav))
        with self.timers.stage("nav.sync"):
            for ch, nav in unsynced:
                feed(ch, nav)

    def status(self) -> dict:
        return {
            ch: {
                "prn": nav.prn,
                **nav.chain.status(),
                "tow_anchor_s": nav.anchor.tow_s if nav.anchor else None,
                "ephemeris": nav.prn in self.ephemerides,
            }
            for ch, nav in self.channels.items()
        }

    def observables(self, smooth_epochs: int = 0,
                    f_if_hz: float = 0.0,
                    carrier_freq_hz: float = 1_575_420_000.0,
                    min_channels: int = 4):
        """Raw observables at the latest common receiver epoch.

        Returns None (fewer than ``min_channels`` usable channels) or a
        dict: prns, pseudoranges_m, transmit_times_s, ephemerides, g_ref
        (common receiver sample), rx_time_nominal_s. Multi-constellation
        fusion calls with ``min_channels=1`` and merges across receivers
        (receiver/multi.py)."""
        usable = []
        for ch, nav in self.channels.items():
            if nav.anchor is None or nav.prn not in self.ephemerides:
                continue
            if ch not in self.latest:
                continue
            usable.append((ch, nav))
        if len(usable) < min_channels:
            return None
        # common receiver reference: earliest of the channels' latest
        # samples (all channels have reached it)
        g_ref = min(self.latest[ch][1] for ch, _ in usable)
        prns, prs, ephs, txs = [], [], [], []
        for ch, nav in usable:
            e, g, cp = self.latest[ch]
            # chip-exact transmit time at the epoch's window start, then
            # shift to the common receiver sample g_ref
            t_epoch = None
            if smooth_epochs > 0:
                t_epoch = nav.smoothed_transmit_time(
                    e, self.fs, f_if_hz, carrier_freq_hz, smooth_epochs
                )
            if t_epoch is None:
                t_epoch = nav.transmit_time_at(e, cp)
            t_tx = t_epoch + (g_ref - g) / self.fs
            txs.append(t_tx)
            ephs.append(self.ephemerides[nav.prn])
            prns.append(nav.prn)
        t0 = max(txs) + 0.068  # nominal common reception time
        for t_tx in txs:
            prs.append((t0 - t_tx) * C.SPEED_OF_LIGHT_M_S)
        return {
            "prns": prns,
            "pseudoranges_m": prs,
            "transmit_times_s": txs,
            "ephemerides": ephs,
            "g_ref": g_ref,
            "rx_time_nominal_s": t0,
        }

    def compute_pvt(self, smooth_epochs: int = 0,
                    f_if_hz: float = 0.0,
                    carrier_freq_hz: float = 1_575_420_000.0,
                    ) -> Optional[PvtSolution]:
        """Single-point solution at the latest common receiver epoch.

        ``smooth_epochs > 0`` uses carrier-smoothed (Hatch) transmit
        times over that many trailing epochs per channel."""
        obs = self.observables(smooth_epochs, f_if_hz, carrier_freq_hz)
        if obs is None:
            return None
        return solve_pvt(
            obs["pseudoranges_m"], obs["ephemerides"],
            obs["transmit_times_s"],
        )

    def compute_velocity(self, position, dopplers: dict[int, float],
                         carrier_freq_hz: float = 1_575_420_000.0):
        """Velocity/clock-drift solution; ``dopplers`` maps channel ->
        measured carrier Doppler (carr_freq - IF) in Hz."""
        usable = []
        for ch, nav in self.channels.items():
            if (nav.anchor is None or nav.prn not in self.ephemerides
                    or ch not in self.latest or ch not in dopplers):
                continue
            usable.append((ch, nav))
        if len(usable) < 4:
            return None
        dops, ephs, txs = [], [], []
        for ch, nav in usable:
            e, g, cp = self.latest[ch]
            txs.append(nav.transmit_time_at(e, cp))
            ephs.append(self.ephemerides[nav.prn])
            dops.append(dopplers[ch])
        return solve_velocity(dops, ephs, txs, position, carrier_freq_hz)
