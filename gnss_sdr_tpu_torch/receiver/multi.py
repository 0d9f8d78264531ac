"""Multi-constellation receiver: several signal pipelines, one stream
(counterpart of ``gnss_sdr_tpu/receiver/multi.py``).

BASELINE.md config ladder 4 (GPS + Galileo + BeiDou + GLONASS, 32
channels) — far beyond the reference, which hardcodes GPS L1 C/A. Each
constellation runs its own Receiver (own code tables, epoch length,
Doppler grids, IF) over a shared sample stream split by ``TeeSource``;
channel counts and configs are per-signal. Every branch runs on one
device (``device``, resolved by each Receiver: the card unless the caller
asks for the CPU).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import ReceiverConfig
from .pipeline import Receiver
from .stream import SampleSource


class _TeeBranch:
    def __init__(self, tee: "TeeSource", idx: int):
        self._tee = tee
        self._idx = idx
        self.fs_hz = tee.source.fs_hz

    def read(self, n: int) -> Optional[np.ndarray]:
        return self._tee._read(self._idx, n)


class TeeSource:
    """Split one SampleSource into independent consumers.

    Replaces the reference's SPMC MulticastRingBuffer role at the host
    boundary (multicast_ring_buffer.rs:36-132): one producer, many
    consumers at independent positions, bounded skew enforced by the
    per-branch buffers: a branch that falls more than ``max_skew``
    samples behind the fastest consumer raises instead of buffering
    without bound (the ring-buffer analogue of an overrun).
    """

    def __init__(self, source: SampleSource, n_branches: int,
                 max_skew: int = 64_000_000):
        self.source = source
        self._buffers: list[list[np.ndarray]] = [[] for _ in range(n_branches)]
        self._eos = False
        self.max_skew = int(max_skew)

    def branch(self, idx: int) -> _TeeBranch:
        return _TeeBranch(self, idx)

    def _read(self, idx: int, n: int) -> Optional[np.ndarray]:
        buf = self._buffers[idx]
        have = sum(b.size for b in buf)
        while have < n and not self._eos:
            fresh = self.source.read(n - have)
            if fresh is None or fresh.size == 0:
                self._eos = True
                break
            for j, b in enumerate(self._buffers):
                b.append(fresh)
                if j != idx:
                    lag = sum(a.size for a in b)
                    if lag > self.max_skew:
                        raise RuntimeError(
                            f"TeeSource branch {j} lags > {self.max_skew} "
                            "samples behind branch "
                            f"{idx} (consumers diverged; raise max_skew "
                            "or drain branches at matched rates)"
                        )
            have += fresh.size
        if not buf:
            return None
        out = np.concatenate(buf) if len(buf) > 1 else buf[0]
        take, rest = out[:n], out[n:]
        buf.clear()
        if rest.size:
            buf.append(rest)
        return take if take.size else None


class MultiConstellationReceiver:
    """Round-robin stepping of per-signal receivers over one stream."""

    def __init__(self, configs: dict[str, ReceiverConfig],
                 source: Optional[SampleSource] = None, *,
                 sources: Optional[dict] = None, device=None):
        """``source``: one host stream, tee-split across signals.
        ``sources``: a per-signal source dict instead (same keys as
        ``configs``) — the device-resident path: DeviceArraySource
        and StreamingDeviceSource hand out device planar pairs that a
        host-side tee cannot buffer, so each branch brings its own.
        ``device`` goes to every branch's Receiver."""
        self.receivers: dict[str, Receiver] = {}
        if sources is not None:
            if set(sources) != set(configs):
                raise ValueError("sources keys must match configs")
            for name, cfg in configs.items():
                self.receivers[name] = Receiver(cfg, sources[name],
                                               device=device)
            return
        if source is None:
            raise ValueError("need source or sources")
        tee = TeeSource(source, len(configs))
        for i, (name, cfg) in enumerate(configs.items()):
            self.receivers[name] = Receiver(cfg, tee.branch(i),
                                           device=device)

    def step(self) -> bool:
        alive = False
        for rx in self.receivers.values():
            alive |= rx.step()
        return alive

    def step_scan(self, k: int) -> bool:
        """Round-robin one ``k``-block stretch per receiver, as a
        device span where that signal's fused scan path allows it
        (Receiver.run handles the steady-mode gating, boundary
        searches, and the single-block fallback for non-fused
        correlators). The tee keeps every branch's stream position
        independent, so one stretch per branch is exactly k sequential
        step()s worth of samples."""
        alive = False
        for rx in self.receivers.values():
            t0 = rx.time_ms
            rx.run(max_blocks=k, scan_blocks=k)
            alive |= rx.time_ms > t0
        return alive

    def run(self, max_blocks: Optional[int] = None,
            scan_blocks: int = 1) -> dict:
        blocks = 0
        if scan_blocks > 1:
            # whole spans only, as in the JAX package (a shorter
            # trailing span is a fresh shape there)
            while ((max_blocks is None
                    or blocks + scan_blocks <= max_blocks)
                   and self.step_scan(scan_blocks)):
                blocks += scan_blocks
            return self.summary()
        while (max_blocks is None or blocks < max_blocks) and self.step():
            blocks += 1
        return self.summary()

    def summary(self) -> dict:
        return {name: rx.summary() for name, rx in self.receivers.items()}

    # -- multi-constellation observables fusion + PVT -------------------
    def observables(self, min_total: int = 4):
        """Merge every constellation's observables at one common
        receiver epoch.

        Each per-signal NavProcessor contributes its usable channels
        (``min_channels=1``); transmit times are re-referenced to the
        EARLIEST per-receiver reference instant (all branches consume
        the same stream, so ``g_ref / fs`` is a shared time base even
        across different decimations), and one common nominal reception
        time forms the pseudoranges. Per-system time-scale offsets
        (GPS-GST/BDT/GLONASST) survive into the pseudoranges as
        per-system constants — exactly what nav/pvt.py's per-system
        clock unknowns absorb.
        """
        per = []
        for name, rx in self.receivers.items():
            obs = rx.nav.observables(min_channels=1)
            if obs is None:
                continue
            per.append((name, rx, obs))
        if not per:
            return None
        t_ref = min(obs["g_ref"] / rx.fs for _, rx, obs in per)
        prns, txs, ephs, systems = [], [], [], []
        for name, rx, obs in per:
            dt = t_ref - obs["g_ref"] / rx.fs   # <= 0: shift backwards
            for prn, tx, eph in zip(obs["prns"], obs["transmit_times_s"],
                                    obs["ephemerides"]):
                prns.append(prn)
                txs.append(tx + dt)
                ephs.append(eph)
                systems.append(getattr(eph, "system", "gps"))
        if len(prns) < min_total:
            return None
        from .. import constants as C

        t0 = max(txs) + 0.068
        prs = [(t0 - tx) * C.SPEED_OF_LIGHT_M_S for tx in txs]
        return {
            "prns": prns,
            "systems": systems,
            "pseudoranges_m": prs,
            "transmit_times_s": txs,
            "ephemerides": ephs,
            "rx_time_nominal_s": t0,
        }

    def compute_pvt(self):
        """Mixed-constellation single-point solution (one receiver
        clock unknown per system; see nav/pvt.py)."""
        from ..nav.pvt import solve_pvt

        obs = self.observables()
        if obs is None:
            return None
        return solve_pvt(
            obs["pseudoranges_m"], obs["ephemerides"],
            obs["transmit_times_s"],
        )
