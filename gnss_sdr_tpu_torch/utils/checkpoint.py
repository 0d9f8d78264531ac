"""Receiver checkpoint / resume (counterpart of
``gnss_sdr_tpu/utils/checkpoint.py``).

The receiver's whole state (the tracking ledger, the rolling sample
window, channel lifecycle maps, search-scheduler pacing, front-end
conditioning state and the per-channel nav decoding chains) serializes
to one file, and a restored receiver continues the stream
deterministically. The window may live on the card: it downloads for the
snapshot and restores onto the restoring receiver's window device. The
front-end state includes the AGC gain, so a resumed AGC continues too.

The caller owns source positioning: resume the sample source at
``consumed_samples()`` output samples times the front-end decimation.

SECURITY: checkpoints are pickle files; loading one executes whatever
the file says. Restore only checkpoints you wrote yourself.
"""
from __future__ import annotations

import pickle
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

if TYPE_CHECKING:  # utils stays importable from receiver
    from ..receiver.pipeline import Receiver

FORMAT_VERSION = 2  # planar window_re/window_im


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, copy=True)


def receiver_state(rx: "Receiver") -> dict[str, Any]:
    """Snapshot everything needed to resume ``rx`` (host values only)."""
    return {
        "version": FORMAT_VERSION,
        "tracking": {name: _host(leaf)
                     for name, leaf in rx.state._asdict().items()},
        "window_re": _host(rx.window.re).astype(np.float32),
        "window_im": _host(rx.window.im).astype(np.float32),
        "window_global_start": rx.window.global_start,
        "blocks_fed": rx.window.blocks_fed,
        "time_ms": rx.time_ms,
        "active": dict(rx.active),
        "scheduler": {
            "mode": rx.scheduler.mode,
            "last_run_ms": rx.scheduler.last_run_ms,
        },
        "frontend": (
            np.uint32(_host(rx._fe_phase)),
            np.float32(_host(rx._fe_bias_re)),
            np.float32(_host(rx._fe_bias_im)),
            np.float32(_host(rx._fe_agc_gain)),
        ),
        "nav": pickle.dumps(rx.nav),
        "telemetry": pickle.dumps(rx.telemetry),
        "acq_events": list(rx.acq_events),
    }


def save(rx: "Receiver", path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(receiver_state(rx), f)


def restore(rx: "Receiver", path: str) -> "Receiver":
    """Load a checkpoint into a freshly constructed Receiver (same
    config; source positioned by the caller). Returns ``rx``."""
    from ..receiver import tracking as trk

    with open(path, "rb") as f:
        snap = pickle.load(f)
    if snap.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported checkpoint version {snap.get('version')}")
    rx.state = trk.state_from_numpy(snap["tracking"])
    rx.window.load(snap["window_re"], snap["window_im"])
    rx.window.global_start = snap["window_global_start"]
    rx.window.blocks_fed = snap["blocks_fed"]
    rx.time_ms = snap["time_ms"]
    rx.active = dict(snap["active"])
    rx.scheduler.mode = snap["scheduler"]["mode"]
    rx.scheduler.last_run_ms = snap["scheduler"]["last_run_ms"]
    (rx._fe_phase, rx._fe_bias_re, rx._fe_bias_im,
     rx._fe_agc_gain) = snap["frontend"]
    rx.nav = pickle.loads(snap["nav"])
    rx.telemetry = pickle.loads(snap["telemetry"])
    rx.acq_events = list(snap["acq_events"])
    return rx


def consumed_samples(rx: "Receiver") -> int:
    """Output-rate samples the receiver has consumed from its source
    (multiply by the decimation factor for raw input samples)."""
    return rx.window.blocks_fed * rx.window.b
