"""The port's real 2-process torch.distributed run (the twin of
tests/test_distributed.py).

Spawns two Python processes (tests/_torch_dist_worker.py) that each call
``parallel.initialize_from_env`` against one address (gloo on the CPU),
form a 4-entry global mesh (2 CPU shards per process) and run
``time_sharded_pcps_search``, whose partial power cubes sum by an
``all_reduce`` across the process boundary. The parent then merges the
per-host shard events with ``merge_shard_results`` and checks them
against the unsharded search each worker recorded
(chip_smoke.dist_check; chip_smoke.py phase 36 runs the same workers on
one card).
"""
import pytest

pytest.importorskip("torch")

import chip_smoke  # noqa: E402


def test_two_process_time_sharded_acquisition(tmp_path):
    results = chip_smoke.dist_run_workers(str(tmp_path), device="cpu",
                                          timeout=300)
    assert [r["device"] for r in results] == ["cpu", "cpu"]
    chip_smoke.dist_check(results)


def test_four_process_time_sharded_acquisition(tmp_path):
    """Four ranks of one shard each (the layout of one rank per card, on
    the CPU here): the 4-entry mesh's cube summed across four
    processes."""
    results = chip_smoke.dist_run_workers(str(tmp_path), device="cpu",
                                          timeout=300, n_procs=4, shards=1)
    assert [r["device"] for r in results] == ["cpu"] * 4
    chip_smoke.dist_check(results)
