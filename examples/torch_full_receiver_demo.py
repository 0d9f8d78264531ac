"""Full-chain demo of the PyTorch/CUDA port (gnss_sdr_tpu_torch): a
synthetic sky with real LNAV broadcasts -> cold start -> acquisition ->
tracking -> live ephemeris decode -> dashboard.

Run from the repository root:

    python examples/torch_full_receiver_demo.py [--cpu] [--seconds S]

It runs on the card unless ``--cpu`` is given (the kernels' plain
PyTorch versions). The dashboard needs matplotlib; without it the demo
says so and skips the plot. It imports no JAX.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gnss_sdr_tpu_torch import ReceiverConfig, RfConfig, TrackConfig  # noqa: E402
from gnss_sdr_tpu_torch.models import SatelliteScenario  # noqa: E402
from gnss_sdr_tpu_torch.nav import (  # noqa: E402
    Ephemeris, encode_frames, encode_words)
from gnss_sdr_tpu_torch.receiver import Receiver, SyntheticSource  # noqa: E402

FS = 2_046_000.0


def sky(seconds: float) -> SyntheticSource:
    """PRN 7 broadcasting subframes 1-3 of an ephemeris between two
    random subframes 4, and PRN 18 without data; the JAX demo's sky."""
    eph = Ephemeris(
        prn=7, week=290, iodc=66, iode=66, t_gd=5.1e-09, t_oc=316800.0,
        a_f1=3.4e-13, a_f0=1.63e-04, c_rs=-45.2, delta_n=4.0e-09, m0=1.22,
        c_uc=-2.5e-06, e=0.013, c_us=5.3e-07, sqrt_a=5154.02,
        t_oe=316784.0, c_ic=-2.2e-07, omega0=-0.985, c_is=3.5e-08,
        i0=0.990, c_rc=387.3, omega=1.0, omega_dot=-8.3e-09, idot=-2e-10)
    rng = np.random.default_rng(1)
    frames = (
        [(4, 500, rng.integers(0, 2, (8, 24)).astype(np.uint8))]
        + [(s, 500 + s, encode_words(eph, s)) for s in (1, 2, 3)]
        + [(4, 504, rng.integers(0, 2, (8, 24)).astype(np.uint8))])
    sats = [
        SatelliteScenario(prn=7, doppler_hz=1234.0, amplitude=0.25,
                          nav_bits=encode_frames(frames)),
        SatelliteScenario(prn=18, doppler_hz=-2800.0, amplitude=0.22,
                          code_phase_chips=512.0),
    ]
    return SyntheticSource(sats, FS, noise_std=1.0, seed=7,
                           total_samples=int(seconds * FS))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--seconds", type=float, default=26.0)
    ap.add_argument("--dashboard", default="receiver_dashboard.png",
                    help="where the dashboard PNG goes")
    args = ap.parse_args(argv)

    rx = Receiver(
        ReceiverConfig(rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
                       track=TrackConfig(n_channels=8), block_ms=100),
        sky(args.seconds), device="cpu" if args.cpu else None)
    t0 = time.perf_counter()
    out = rx.run()
    wall = time.perf_counter() - t0
    print(f"{out['time_ms'] / 1000:.1f} s of signal in {wall:.1f} s wall "
          f"({out['time_ms'] / 1000 / wall:.1f}x real time) on "
          f"{rx.device}")
    print("tracked:", out["tracked_prns"], " nav:", out["nav"])
    for prn, e in rx.nav.ephemerides.items():
        print(f"decoded ephemeris PRN {prn}: sqrt_a={e.sqrt_a:.3f} "
              f"e={e.e:.5f} week={e.week}")
    try:
        from gnss_sdr_tpu_torch.utils import plot_receiver_state

        plot_receiver_state(rx, args.dashboard)
        print(f"dashboard -> {args.dashboard}")
    except RuntimeError as e:              # no matplotlib
        print(f"dashboard skipped: {e}")
    return out


if __name__ == "__main__":
    main()
