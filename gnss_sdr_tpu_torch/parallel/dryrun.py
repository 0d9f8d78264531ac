"""Multi-shard dry run of the port (counterpart of
``__graft_entry__.dryrun_multichip``): the flagship step with the
channel state sharded, the time-sharded search, and the fused
multi-block scan channel-sharded on the direct and mxu layouts, each
over ``n_devices`` shards at tiny shapes.

    python -m gnss_sdr_tpu_torch.parallel.dryrun [N] [--cpu]

On the card every shard sits on the one card the caller names (a mesh
of N logical shards of it); on the CPU, of the CPU device.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import TrackConfig
from ..device import resolve_device
from ..models import GPS_L1CA, SatelliteScenario, synthesize
from ..ops import pcps
from ..receiver import fused_runner as fr
from ..receiver import tracking as trk
from . import sharding


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the flagship step (a PRN-sharded search and a channel-sharded
    tracking block), the time-sharded search and the fused multi-block
    scan (direct and mxu, channel-sharded) over an ``n_devices``-shard
    mesh on ``device`` (by default the card), at tiny shapes. Returns
    each part's mesh shape; a dropped epoch raises."""
    dev = resolve_device(device)
    spec = GPS_L1CA
    mesh = sharding.make_mesh(n_time=1, n_channel=n_devices, devices=dev)

    # the flagship step (__graft_entry__._build): search + tracking block
    fs, n_int, block_epochs = 1_023_000.0, 4, 8
    n0 = spec.samples_per_code(fs)
    params = trk.TrackParams.create(TrackConfig(n_channels=n_devices),
                                    spec, fs)
    code_ffts = pcps.code_replica_ffts(spec, fs, n_devices, device=dev)
    grid = torch.from_numpy(pcps.doppler_grid(14_000.0, 500.0)).to(dev)
    codes = trk.make_code_table(spec, n_devices)
    state = trk.init_state(n_devices)
    for ch in range(n_devices):
        state = trk.start_channel(state, ch, ch % n_devices,
                                  1000.0 + 100.0 * ch, ch * 7,
                                  spec.code_rate_hz)
    rng = np.random.default_rng(0)
    block_len = (block_epochs + 1) * n0 + params.window
    block_re = rng.standard_normal(block_len).astype(np.float32)
    block_im = rng.standard_normal(block_len).astype(np.float32)
    acq = (rng.standard_normal(n_int * n0)
           + 1j * rng.standard_normal(n_int * n0)).astype(np.complex64)
    res = sharding.sharded_pcps_search(mesh, torch.from_numpy(acq),
                                       code_ffts, grid, fs_hz=fs,
                                       n_int=n_int)
    new_state, telem = sharding.sharded_track_block(
        mesh, params, codes[np.maximum(state.prn_idx, 0)], state, block_re,
        block_im, block_epochs)
    assert res.ratio.shape == (n_devices,)
    assert new_state.offset.shape == state.offset.shape
    assert telem.i_p.shape == (block_epochs, n_devices)

    # the time-sharded search over the same shards
    tmesh = sharding.make_mesh(n_time=n_devices, n_channel=1, devices=dev)
    n_int_t = 2 * n_devices
    stream = (rng.standard_normal(n_int_t * n0)
              + 1j * rng.standard_normal(n_int_t * n0)).astype(np.complex64)
    tres = sharding.time_sharded_pcps_search(
        tmesh, torch.from_numpy(stream), code_ffts,
        torch.from_numpy(pcps.doppler_grid(7_000.0, 500.0)), fs_hz=fs,
        n_int=n_int_t)
    assert tres.ratio.shape == (n_devices,)

    # the fused multi-block scan, channel-sharded, on direct and mxu
    ffs, t_ep, n_blk = 2_046_000.0, 20, 2
    fn0 = spec.samples_per_code(ffs)
    fcfg = TrackConfig(n_channels=n_devices, correlator="fused")
    fparams = trk.TrackParams.create(fcfg, spec, ffs)
    fcodes = trk.make_sampled_code_table(spec, ffs, 32,
                                         window=fparams.window)
    frows = torch.from_numpy(fcodes[np.arange(n_devices) % 32]).to(dev)
    fblock, fhist = t_ep * fn0, 2 * fn0 + 4096
    fsig = synthesize(
        [SatelliteScenario(prn=p + 1, doppler_hz=700.0 + 120.0 * p)
         for p in range(n_devices)],
        fhist + n_blk * fblock, ffs, noise_std=0.3, seed=12)
    for layout in ("direct", "mxu"):
        ft = fr.FusedTracker(fparams, fcfg, spec, ffs, fcodes, t_ep,
                             fhist + fblock, layout=layout, mesh=mesh,
                             device=dev)
        fstate = trk.init_state(n_devices)
        for ch in range(n_devices):
            fstate = trk.start_channel(fstate, ch, ch % 32,
                                       700.0 + 120.0 * ch, fn0 + 31 + 61 * ch,
                                       spec.code_rate_hz)
        _, telems = ft.run_blocks(
            fstate, np.real(fsig).astype(np.float32),
            np.imag(fsig).astype(np.float32), frows, n_blk)
        assert len(telems) == n_blk
        assert telems[-1].processed.all(), (
            f"fused ({layout}) mesh scan dropped epochs")
    out = {"step": mesh.shape, "time_sharded": tmesh.shape,
           "fused_scan": mesh.shape, "device": str(dev)}
    print(f"dryrun_multichip({n_devices}): ok on {dev}: state sharded over "
          f"{mesh.shape}; time-sharded acquisition over {tmesh.shape}; "
          f"fused multi-block scan (direct and mxu) channel-sharded over "
          f"{mesh.shape}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gnss_sdr_tpu_torch.parallel.dryrun")
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="shards of the CPU device (default: the card)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, "cpu" if args.cpu else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
