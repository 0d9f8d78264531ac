"""Live (periodically refreshing) receiver view (counterpart of
``gnss_sdr_tpu/utils/live.py``).

Capability parity with the reference's NavigationView intent
(src/view.rs:37-116: a window re-plotting satellite visibility bars and
prompt I/Q at ~6 fps while the receiver runs). Accelerator hosts are headless,
so the live surface here is twofold and file/terminal based:

  * a terminal status table (one ANSI-refreshed frame per render):
    per-channel PRN / state / C/N0 / Doppler / prompt power / nav
    progress, plus the current PVT fix when available;
  * an optionally re-rendered PNG dashboard (utils/view.py
    plot_receiver_state) written atomically (tmp + rename) so an
    external viewer polling the file never sees a torn frame.

Refresh is wall-clock paced (default the reference's 6 fps cap) and
driven from the receiver loop via ``Receiver.run(on_block=view)`` — the
view is a callable, so any per-block hook composes the same way.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np


class LiveView:
    """Periodic live rendering of a running Receiver.

    Use as ``Receiver.run(on_block=LiveView(rx, ...))`` or call
    ``view.refresh()`` manually. ``interval_s`` caps the render rate
    (wall clock); ``refresh(force=True)`` renders unconditionally.
    """

    def __init__(
        self,
        receiver,
        png_path: Optional[str] = None,
        interval_s: float = 1.0 / 6.0,
        terminal: bool = True,
        stream=None,
        ansi: Optional[bool] = None,
    ):
        self.rx = receiver
        self.png_path = png_path
        self.interval_s = float(interval_s)
        self.terminal = terminal
        self.stream = stream if stream is not None else sys.stdout
        # ANSI cursor-home redraw only when talking to a real terminal
        # (piped output degrades to appended frames)
        self.ansi = (self.stream.isatty() if ansi is None else ansi)
        self.renders = 0
        self._last_render = -float("inf")

    # -- hook protocol ---------------------------------------------------
    def __call__(self, receiver=None) -> None:
        self.refresh()

    def refresh(self, force: bool = False) -> bool:
        now = time.monotonic()
        if not force and now - self._last_render < self.interval_s:
            return False
        self._last_render = now
        if self.terminal:
            frame = self.render_text()
            if self.ansi:
                # cursor home + clear-to-end: repaint in place
                self.stream.write("\x1b[H\x1b[J" + frame)
            else:
                self.stream.write(frame + "\n")
            self.stream.flush()
        if self.png_path is not None:
            self._render_png()
        self.renders += 1
        return True

    # -- renderers ---------------------------------------------------------
    def render_text(self) -> str:
        rx = self.rx
        lines = [
            f"t={rx.time_ms / 1000.0:8.2f} s   "
            f"channels {len(rx.active)}/{rx.cfg.track.n_channels} active",
            f"{'PRN':>4} {'C/N0':>6} {'Doppler':>9} {'power':>10} "
            f"{'lock':>5} {'eph':>4}",
        ]
        active = np.asarray(rx.state.active)
        prns = np.asarray(rx.state.prn_idx) + 1
        for ch in range(active.shape[0]):
            if not active[ch]:
                continue
            prn = int(prns[ch])
            trace = rx.telemetry.traces.get(ch)
            cn0 = doppler = power = None
            locked = False
            if trace is not None and len(trace.i_p):
                cn0 = trace.cn0_dbhz()
                i_p = np.asarray(trace.i_p[-20:])
                q_p = np.asarray(trace.q_p[-20:])
                power = float(np.mean(i_p**2 + q_p**2))
                locked = power > rx.cfg.track.lock_threshold
                if len(trace.carr_freq):
                    doppler = float(trace.carr_freq[-1]) - rx.f_if
            has_eph = prn in getattr(rx.nav, "ephemerides", {})
            lines.append(
                f"{prn:>4} "
                f"{(f'{cn0:6.1f}' if cn0 is not None else '     -')} "
                f"{(f'{doppler:9.1f}' if doppler is not None else '        -')} "
                f"{(f'{power:10.1f}' if power is not None else '         -')} "
                f"{'  yes' if locked else '   no'} "
                f"{' yes' if has_eph else '  no'}"
            )
        sol = None
        try:
            sol = rx.compute_pvt()
        except Exception:
            pass
        if sol is not None:
            x, y, z = sol.position_ecef_m
            lines.append(
                f"fix: ECEF ({x:.1f}, {y:.1f}, {z:.1f}) m   "
                f"gdop {sol.gdop:.2f}"
            )
        else:
            n_eph = len(getattr(rx.nav, "ephemerides", {}))
            lines.append(f"fix: - ({n_eph} ephemerides decoded)")
        return "\n".join(lines)

    def _render_png(self) -> None:
        from .view import plot_receiver_state

        tmp = f"{self.png_path}.tmp{os.getpid()}.png"
        plot_receiver_state(self.rx, tmp)
        os.replace(tmp, self.png_path)
