"""Worker of the port's real 2-process torch.distributed test (the twin
of tests/_dist_worker.py).

Launched by tests/test_torch_distributed.py (and chip_smoke.py on the
card) as
``python _torch_dist_worker.py <host:port> <n_procs> <rank> <out.json>
[device] [shards]``.

Each process starts the default process group with
``parallel.initialize_from_env`` (gloo: named on the CPU, the default
choice where the ranks share one card), builds a global time mesh of
``shards`` entries of ``device`` per process (2 by default) and runs
``time_sharded_pcps_search`` on it, so
the partial power cubes are summed by an ``all_reduce`` across the
process boundary; the result must equal this process's unsharded
search. ``device`` "cards" takes the process's own cards instead, as
under torchrun (LOCAL_RANK and LOCAL_WORLD_SIZE set by the parent): the
backend and the mesh's devices both by default (NCCL where each rank
has cards of its own). Then it walks the host-ingest path:
``partition_stream`` gives this host its time shard (with halo), the shard's core is acquired
locally, and the detections are written out keyed by global sample
index for the parent to merge with ``merge_shard_results``.
"""
import json
import sys

import numpy as np


def main() -> None:
    addr, n_procs, rank, out_path = (sys.argv[1], int(sys.argv[2]),
                                     int(sys.argv[3]), sys.argv[4])
    device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    shards = int(sys.argv[6]) if len(sys.argv) > 6 else 2

    import torch

    from gnss_sdr_tpu_torch import parallel
    from gnss_sdr_tpu_torch.models import GPS_L1CA, signal
    from gnss_sdr_tpu_torch.ops import pcps

    torch.set_num_threads(2)
    own = None
    # CPU shards: gloo whatever cards the host has; on a card, the
    # default choice (gloo where the ranks share it)
    assert parallel.initialize_from_env(
        master_addr=addr, world_size=n_procs, rank=rank,
        backend="gloo" if device == "cpu" else None)
    backend = torch.distributed.get_backend()
    assert torch.distributed.get_world_size() == n_procs
    if device == "cards":
        own = parallel.local_devices(n_procs, rank)
        device, shards = own[0], len(own)

    fs = 2_046_000.0
    n0 = GPS_L1CA.samples_per_code(fs)
    # 10 ms a host, so each host's authoritative part still integrates
    # the 10 ms the threshold 7 is calibrated for
    n_int = 10 * n_procs
    n_time = shards * n_procs
    scene = [
        signal.SatelliteScenario(prn=5, doppler_hz=1500.0,
                                 code_phase_chips=210.0).with_code_doppler(),
        signal.SatelliteScenario(prn=17, doppler_hz=-2500.0,
                                 code_phase_chips=700.5).with_code_doppler(),
    ]
    # every process renders the identical whole stream
    samples = torch.from_numpy(signal.synthesize(
        scene, n_int * n0, fs, noise_std=4.0, seed=7))
    code_ffts = pcps.code_replica_ffts(GPS_L1CA, fs, 32, device=device)
    grid = torch.from_numpy(pcps.doppler_grid(7_000.0, 500.0)).to(device)

    # the unsharded reference, in this process alone
    ref = pcps.pcps_search(samples.to(device), code_ffts, grid, fs_hz=fs,
                           n_int=n_int)

    # the time-sharded search: the partial cubes all-reduced across the
    # process boundary
    mesh = parallel.global_mesh(
        n_time=n_time, devices=None if own else [device] * shards)
    assert mesh.shape == {"time": n_time, "channel": 1}
    assert mesh.spans_processes
    assert mesh.owners[:, 0].tolist() == [r for r in range(n_procs)
                                          for _ in range(shards)]
    assert mesh.home == torch.device(device)
    out = parallel.time_sharded_pcps_search(mesh, samples, code_ffts, grid,
                                            fs_hz=fs, n_int=n_int)
    np.testing.assert_array_equal(out.detected.cpu().numpy(),
                                  ref.detected.cpu().numpy())
    np.testing.assert_array_equal(out.code_phase_samples.cpu().numpy(),
                                  ref.code_phase_samples.cpu().numpy())
    np.testing.assert_allclose(out.ratio.cpu().numpy(),
                               ref.ratio.cpu().numpy(), rtol=1e-4)

    # the host-ingest path: this host acquires only its time shard
    shards = parallel.partition_stream(n_int * n0, n_hosts=n_procs, halo=n0)
    me = shards[rank]
    local = signal.synthesize(scene, me.count, fs, noise_std=4.0, seed=7,
                              start_sample=me.start)
    n_local_int = me.core_count // n0
    loc = pcps.pcps_search(
        torch.from_numpy(local[: n_local_int * n0]).to(device), code_ffts,
        grid, fs_hz=fs, n_int=n_local_int)
    detected = loc.detected.cpu().numpy()
    lags = loc.code_phase_samples.cpu().numpy()
    freqs = loc.carrier_freq_hz.cpu().numpy()
    events = []
    for p in range(32):
        if detected[p]:
            # the global code phase: the shard-local lag plus the
            # shard's start, folded into one code period
            phase = int((int(lags[p]) + me.start) % n0)
            events.append({"prn": p + 1, "global_sample": phase
                           + me.core_start, "code_phase": phase,
                           "carrier_freq_hz": float(freqs[p])})
    ref_det = ref.detected.cpu().numpy()
    ref_lag = ref.code_phase_samples.cpu().numpy()
    with open(out_path, "w") as f:
        json.dump({
            "rank": rank,
            "world_size": torch.distributed.get_world_size(),
            "backend": backend,
            "device": str(mesh.home),
            "mesh_devices": len(mesh.devices.reshape(-1)),
            "timeshard_matches_reference": True,
            "ref_detected_prns": [p + 1 for p in range(32) if ref_det[p]],
            "ref_code_phase": {str(p + 1): int(ref_lag[p])
                               for p in range(32) if ref_det[p]},
            "shard": {"start": me.start, "count": me.count,
                      "core_start": me.core_start,
                      "core_count": me.core_count, "halo": me.halo},
            "events": events,
        }, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
