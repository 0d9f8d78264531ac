"""Multi-process glue on ``torch.distributed`` (counterpart of
``gnss_sdr_tpu/parallel/distributed.py``).

Process-group start-up, meshes that span processes, and the host-level
partitioning of a sample stream: each host ingests its own time slice
with a trailing halo, so acquisition chunks and tracking windows near a
shard boundary stay whole (overlap-save); the partial power cubes of a
time-sharded search then sum across processes with ``all_reduce``
(sharding.time_sharded_pcps_search).

A single process works unchanged: every helper degrades to the
one-process case.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .sharding import Mesh, make_mesh


def _local_ranks(world_size: int, rank: int) -> tuple[int, int]:
    """(ranks on this host, this rank's place among them): torchrun's
    LOCAL_WORLD_SIZE and LOCAL_RANK, else the whole world and ``rank``."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return local, int(os.environ.get("LOCAL_RANK", rank % local))


def local_devices(world_size: int = 1, rank: int = 0) -> list:
    """This rank's own cards, where the host's cards are dealt out to its
    ranks (``_local_ranks``) in equal runs: with 4 cards and 2 ranks,
    rank 0 ``cuda:0, cuda:1`` and rank 1 ``cuda:2, cuda:3``. Where the
    ranks outnumber the cards they share them, card ``local_rank mod
    count`` each. Raises without a card, as every entry point of the
    port does.

    A launcher that gives each rank its own cards through
    CUDA_VISIBLE_DEVICES leaves every rank seeing ``cuda:0`` and is taken
    for ranks sharing a card: pass ``backend="nccl"`` to
    initialize_from_env, and ``devices`` to global_mesh."""
    resolve_device(None)
    count = torch.cuda.device_count()
    local, local_rank = _local_ranks(world_size, rank)
    if count < local:
        return [torch.device("cuda", local_rank % count)]
    per = count // local
    return [torch.device("cuda", i)
            for i in range(local_rank * per, (local_rank + 1) * per)]


def _pick_backend(world_size: int, rank: int) -> str:
    """gloo on the CPU and where the ranks on this host outnumber its
    cards (NCCL refuses two ranks on one GPU); NCCL where each rank has
    cards of its own (local_devices: the same rule)."""
    if not torch.cuda.is_available():
        return "gloo"
    local, _ = _local_ranks(world_size, rank)
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def initialize_from_env(master_addr: Optional[str] = None,
                        world_size: Optional[int] = None,
                        rank: Optional[int] = None,
                        backend: Optional[str] = None) -> bool:
    """Start the default process group (``torch.distributed.
    init_process_group`` over ``tcp://``).

    Arguments default to torchrun's environment variables: MASTER_ADDR
    and MASTER_PORT (``master_addr`` may also carry the port, as
    "host:port"), WORLD_SIZE and RANK. Returns True when a group of more
    than one process was started, False for a single process (no
    world size above 1 and no address), as the JAX package's does.

    ``backend`` defaults to gloo on the CPU and where the ranks on this
    host outnumber its cards, so that ranks share a card (NCCL refuses
    two ranks on one GPU), and to NCCL where each rank has cards of its
    own (local_devices). Under NCCL the rank's first own card is made
    current, as NCCL needs. A backend that fails raises; there is no
    retry on another backend."""
    if master_addr is None:
        master_addr = os.environ.get("MASTER_ADDR")
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size <= 1 and master_addr is None:
        return False
    if master_addr is None:
        raise ValueError(f"world_size={world_size} needs a master address "
                         "(master_addr or MASTER_ADDR)")
    host, _, port = master_addr.rpartition(":")
    if not host:
        host, port = master_addr, os.environ.get("MASTER_PORT", "29500")
    if backend is None:
        backend = _pick_backend(world_size, rank)
    if backend == "nccl":
        torch.cuda.set_device(local_devices(world_size, rank)[0])
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{host}:{port}", world_size=world_size,
        rank=rank)
    return True


def global_mesh(n_time: int = 1, n_channel: Optional[int] = None,
                devices=None) -> Mesh:
    """(time, channel) mesh over every process's devices: the world size
    times this process's ``devices``, each process holding the same
    number. Rank r holds the grid entries ``r * n_local`` to
    ``(r + 1) * n_local - 1`` in row-major order.

    ``devices`` defaults to this rank's own cards (local_devices). Under
    an NCCL group every device given must be one of them: two ranks on
    one card would reach NCCL as one GPU twice (ValueError). Without a
    process group it is make_mesh over ``devices`` (every visible card
    by default)."""
    if not (torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        return make_mesh(n_time, n_channel, devices)
    world = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    own = None
    if devices is None or torch.distributed.get_backend() == "nccl":
        own = local_devices(world, rank)
    local = make_mesh(1, None, own if devices is None else devices)
    local_devs = list(local.devices.reshape(-1))
    if own is not None and not set(local_devs) <= set(own):
        raise ValueError(
            f"an NCCL group needs each rank on its own cards: rank {rank} "
            f"holds {[str(d) for d in own]}, was given "
            f"{[str(d) for d in local_devs]}")
    n_local = len(local_devs)
    everything = local_devs * world
    owners = [r for r in range(world) for _ in range(n_local)]
    mesh = make_mesh(n_time, n_channel, everything)
    n = mesh.devices.size
    return Mesh(mesh.devices,
                np.asarray(owners[:n]).reshape(mesh.devices.shape), rank)


@dataclasses.dataclass(frozen=True)
class TimeShard:
    """One host's slice of the global sample stream."""

    host_id: int
    start: int          # global sample index this host ingests from
    count: int          # samples it ingests (including the halo)
    halo: int           # trailing overlap shared with the next host
    core_start: int     # first sample this host is authoritative for
    core_count: int     # samples it is authoritative for


def partition_stream(total_samples: int, n_hosts: int,
                     halo: int) -> list[TimeShard]:
    """Split a stream into per-host time shards with trailing halos.

    Host h owns samples [h*B, (h+1)*B) (B = total/n_hosts) and also
    ingests ``halo`` samples beyond its end, so windows and acquisition
    chunks that cross the boundary stay local."""
    if total_samples % n_hosts:
        raise ValueError(
            f"total_samples={total_samples} not divisible by {n_hosts}")
    block = total_samples // n_hosts
    if halo >= block:
        raise ValueError(f"halo={halo} must be < per-host block {block}")
    shards = []
    for h in range(n_hosts):
        start = h * block
        extra = halo if h < n_hosts - 1 else 0
        shards.append(TimeShard(
            host_id=h, start=start, count=block + extra, halo=extra,
            core_start=start, core_count=block))
    return shards


def merge_shard_results(shards: list[TimeShard],
                        per_shard_events: list[list[dict]]) -> list[dict]:
    """Merge per-host event lists (e.g. acquisition candidates keyed by
    'global_sample'), keeping each event only from its authoritative
    shard, so halo regions never report twice."""
    out = []
    for shard, events in zip(shards, per_shard_events):
        lo = shard.core_start
        hi = shard.core_start + shard.core_count
        for ev in events:
            g = ev.get("global_sample", lo)
            if lo <= g < hi:
                out.append(ev)
    return sorted(out, key=lambda e: e.get("global_sample", 0))
