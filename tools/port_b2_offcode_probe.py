"""Where B1 and B2 part from their plain version on channels that track
noise (the PyTorch port, on a CUDA card).

chip_smoke.py holds the mxu kernels to their plain version open loop on
the 24-satellite scene, where every channel's code lines up with its
window. Started at random 128-multiples above a shared base instead
(chip_smoke.offcode_case), no channel's code lines up: every channel
tracks noise. This probe runs, at full width (32 channels, 2.046 MHz,
500 ms blocks), for power and Costas lock and a few seeds:

  * B2 against B1 kernel to kernel (bit for bit, as chip_smoke checks);
  * B2 against its plain version and B1 against its plain version open
    loop (each pair of supersteps from the kernel's state), on the
    off-code starts and, for contrast, on the scene's own (aligned)
    starts, reporting instead of raising: each rate column's largest
    error over chip_smoke.compare's tolerance (1 mHz + 1e-4 |f|), where
    it falls, and that channel's prompt magnitude and carrier rate.

It also reports chip_smoke's Costas spread case (the ledger moved by
whole code periods, seed 6), where a channel loses its lock: for each
channel that dies, and each that starts within 5 degrees of the Costas
loop's +-90 degree point, its starting carrier-phase error, its first
discriminator values, carrier rates and lock flags, and the epoch it
is lost (``--costas-only --device cpu`` runs this part alone on the
CPU, through the plain version).

Run from the repository root on a machine with a CUDA card:

    python3 tools/port_b2_offcode_probe.py [--seeds 0 1 2]

It prints the card's name and power limit first, then one JSON line per
(lock mode, seed, starts, kernel) and per reported Costas channel.
Needs no JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

RATE_COLS = {10: "carr_freq", 11: "code_rate", 17: "held_carr",
             18: "held_code"}


def open_loop_pieces(torch, kernel, plain, args, kw):
    """chip_smoke.open_loop_compare's pieces without its checks: the
    kernel's telemetry over the block, and the plain version's, each
    pair of supersteps run from the kernel's state at its start."""
    k, t_all = kw["k_epochs"], kw["t_epochs"]
    tk, sk = kernel(*args, **kw)
    st, pieces = args[4], []
    for e0 in range(0, t_all, 2 * k):
        e1 = e0 + 2 * k
        s_next = kernel(*args, **dict(kw, t_epochs=e1))[1] \
            if e1 < t_all else sk
        tr, _ = plain(*args[:4], st, **dict(kw, t_epochs=2 * k),
                      first_superstep=e0 // k)
        pieces.append(tr)
        st = s_next
    torch.cuda.synchronize()
    return (tk.double().cpu().numpy(),
            torch.cat(pieces).double().cpu().numpy())


def rate_report(tk, tr):
    """Each rate column's largest |kernel - plain| over compare's
    tolerance, where it falls, and what that channel held there."""
    out = {}
    p_mag = np.hypot(tr[..., 2], tr[..., 3])
    for k, name in RATE_COLS.items():
        tol = chip_smoke.RATE_ATOL_HZ + 1e-4 * np.abs(tr[..., k])
        ratio = np.abs(tk[..., k] - tr[..., k]) / tol
        e, c = np.unravel_index(int(np.argmax(ratio)), ratio.shape)
        out[name] = {
            "max_ratio": float(ratio[e, c]),
            "channels_over_1": int((ratio.max(axis=0) >= 1.0).sum()),
            "epoch": int(e), "channel": int(c),
            "rate_hz": float(tr[e, c, k]),
            "diff_hz": float(tk[e, c, k] - tr[e, c, k]),
            "tol_hz": float(tol[e, c]),
        }
    worst = out["carr_freq"]
    e, c = worst["epoch"], worst["channel"]
    worst["prompt_mag"] = float(p_mag[e, c])
    worst["prompt_diff"] = float(np.hypot(tk[e, c, 2] - tr[e, c, 2],
                                          tk[e, c, 3] - tr[e, c, 3]))
    worst["pll_err_diff"] = float(tk[e, c, 8] - tr[e, c, 8])
    worst["locked_share"] = float(tr[:, c, 7].mean())
    processed = tr[..., 16] > 0.5
    out["prompt_mag_median"] = float(np.median(p_mag[processed]))
    out["bf16_cols_max_rel"] = max(
        float(np.abs(tk[..., k] - tr[..., k]).max())
        / max(float(np.abs(tr[..., k]).max()), 1e-30)
        for k in chip_smoke.BF16_COLS)
    return out


def costas_report(torch, device, seed=6):
    """chip_smoke's Costas spread case (its seed for the Costas variant)
    and, beside it, the scene's own starts: the channels that die or
    start within 5 degrees of +-90 (the prompt's angle at epoch 0,
    folded into [-90, 90): the Costas loop's phase error)."""
    from gnss_sdr_tpu_torch.models import SatelliteScenario
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    sats = chip_smoke.scene_sats(SatelliteScenario)
    for case, spread_seed in (("spread", seed), ("clamped", None)):
        _, args, kw = chip_smoke.full_width_inputs(
            torch, device, {"lock_mode": "costas"}, shared_fetch=True,
            spread_seed=spread_seed)
        t, s = fused.track_block_fused_mxu(*args, **kw)
        t = t.double().cpu().numpy()
        alive = s[:, 7].cpu().numpy() > 0.5
        fold = (np.degrees(np.arctan2(t[0, :, 3], t[0, :, 2])) + 90.0) \
            % 180.0 - 90.0
        for c in range(len(sats)):
            if alive[c] and abs(fold[c]) <= 85.0:
                continue
            print(json.dumps({
                "costas_case": case, "base": int(kw["starts_host"][-1]),
                "channel": c, "prn": sats[c].prn,
                "doppler_hz": sats[c].doppler_hz,
                "phase_err0_deg": round(float(fold[c]), 2),
                "alive": bool(alive[c]),
                "lost_epoch": (int(np.argmax(t[:, c, 15])) if not alive[c]
                               else None),
                "pll_err_cycles": np.round(t[:4, c, 8], 4).tolist(),
                "carr_freq_hz": np.round(t[:4, c, 10], 2).tolist(),
                "locked": t[:4, c, 7].tolist(),
                "carr_freq_at_loss_hz": round(float(t[-1, c, 10]), 2)}))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--costas-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()
    if opts.costas_only:
        costas_report(torch, opts.device)
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    chip_smoke.phase_device(torch)          # the card's name, power limit
    chip_smoke.phase_build()
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    kernel = fused.track_block_fused_mxu
    plain = fused.track_block_fused_mxu_reference
    for mode, cfg_kw in (("power", {}), ("costas", {"lock_mode": "costas"})):
        _, args, kw = chip_smoke.full_width_inputs(torch, "cuda", cfg_kw,
                                                   shared_fetch=True)
        for seed in opts.seeds:
            cases = {"offcode": chip_smoke.offcode_case(args, kw, seed)}
            if seed == opts.seeds[0]:
                cases["aligned"] = (args, kw)
            for starts, (c_args, c_kw) in cases.items():
                chip_smoke.b2_equals_b1(torch, c_args, c_kw)
                b1_args, b1_kw = chip_smoke.b1_of(c_args, c_kw)
                for name, (a, k) in (("B2", (c_args, c_kw)),
                                     ("B1", (b1_args, b1_kw))):
                    tk, tr = open_loop_pieces(torch, kernel, plain, a, k)
                    print(json.dumps({
                        "lock": mode, "seed": seed, "starts": starts,
                        "base": int(c_kw["starts_host"][-1]),
                        "kernel": name, **rate_report(tk, tr)}))
    costas_report(torch, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
