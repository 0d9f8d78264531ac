"""Device-mesh sharding of acquisition and tracking (counterpart of
``gnss_sdr_tpu/parallel/sharding.py``).

The same two axes as the JAX package:

  * **channel axis**: tracking channels (and acquisition PRN rows) are a
    batch dimension; each shard tracks its own rows with no exchange
    between shards in the steady state (a channel's loop state lives on
    the shard that owns it);
  * **time axis**: acquisition's non-coherent integrations are
    independent 1 ms correlations; each time shard integrates its slice
    of the chunk, its Doppler ramp started at the slice's global sample
    (the u32 NCO's ``sample_offset``), and the partial power cubes sum.

Tracking is sequential in time per channel (the loop filters carry), so
the time axis applies to acquisition only.

PyTorch has no in-process SPMD like ``shard_map``: the port's mesh is a
grid of devices that these functions walk, launching each shard's work
on its device, with that card current, and gathering the results. Work
on distinct cards overlaps (nothing here waits for a card between
shards); shards on one device run one after another on its current
stream. Channel-sharded work runs on the grid's first row (the time
axis replicates it, as in the JAX package), all of it in the calling
process.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import pcps
from ..receiver import tracking as trk
from ..utils.profiling import StageTimer

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


class Mesh:
    """A (time, channel) grid of devices.

    ``devices``: [n_time, n_channel] numpy object array of
    ``torch.device``; ``owners``: the rank of the process that holds each
    entry (all 0 within one process; ``distributed.global_mesh`` sets
    them); ``rank``: the calling process's. ``shape`` is the dict
    ``{"time": n_time, "channel": n_channel}``, as JAX's ``Mesh.shape``."""

    axis_names = (TIME_AXIS, CHANNEL_AXIS)

    def __init__(self, devices: np.ndarray, owners=None, rank: int = 0):
        self.devices = devices
        self.owners = (np.zeros(devices.shape, np.int64) if owners is None
                       else np.asarray(owners))
        self.rank = rank

    @property
    def shape(self) -> dict:
        n_time, n_channel = self.devices.shape
        return {TIME_AXIS: n_time, CHANNEL_AXIS: n_channel}

    @property
    def spans_processes(self) -> bool:
        return bool((self.owners != self.owners.flat[0]).any())

    def is_local(self, t: int, c: int) -> bool:
        return int(self.owners[t, c]) == self.rank

    @property
    def home(self) -> torch.device:
        """The first grid entry this process holds: where gathered
        results land."""
        t, c = np.argwhere(self.owners == self.rank)[0]
        return self.devices[t, c]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={self.devices.tolist()}, "
                f"rank={self.rank})")


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the card it means now (``cuda:<current>``), so that
    one card is one device of the grid whichever way it was named."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_time: int = 1, n_channel: Optional[int] = None,
              devices=None) -> Mesh:
    """A (time, channel) mesh over ``devices``, by default every visible
    card (``cuda:0`` .. ``cuda:count-1``; with no card this raises, as
    every entry point of the port does). ``n_channel`` defaults to the
    devices left per time row. A mesh that needs more devices than
    there are raises ValueError naming both counts.

    ``devices`` may name one device more than once: its shards then run
    one after another on that device's current stream. A single device
    (not a list) stands for every entry of the grid (``n_channel``
    defaults to 1 then). This is how the CPU tests build a mesh of
    logical shards of the one CPU device (the JAX suite's eight virtual
    host devices), and how one card holds a mesh of two or four
    shards."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * (n_time * (n_channel or 1))
    devices = [_indexed(resolve_device(d)) for d in devices]
    if n_channel is None:
        n_channel = len(devices) // n_time
    n = n_time * n_channel
    if n < 1:
        raise ValueError(f"mesh {n_time}x{n_channel} has no device")
    if n > len(devices):
        raise ValueError(f"mesh {n_time}x{n_channel} needs {n} devices, "
                         f"have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(n_time, n_channel))


def _channel_devices(mesh: Mesh) -> list:
    """The channel shards' devices (the grid's first row), each held by
    this process."""
    row = list(mesh.devices[0])
    if not all(mesh.is_local(0, c) for c in range(len(row))):
        raise ValueError(
            f"a channel-sharded call needs every channel shard in this "
            f"process (rank {mesh.rank}); the mesh's first row is held by "
            f"ranks {mesh.owners[0].tolist()}")
    return row


def shard_rows(n_rows: int, mesh: Mesh, what: str = "n_channels") -> int:
    """The rows of each channel shard: ``n_rows`` over the mesh's
    channel axis, which must divide it (ValueError otherwise). The
    receiver and the fused tracker call it when they are given a mesh;
    every sharded call here splits by it."""
    n = mesh.shape[CHANNEL_AXIS]
    if n_rows % n:
        raise ValueError(f"{what}={n_rows} not divisible by the mesh "
                         f"channel axis ({n})")
    return n_rows // n


def _current(device: torch.device):
    """``device`` made the current card (a no-op on the CPU): a shard's
    copies, kernels and graph run on its own card's current stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# channel-sharded tracking
# ---------------------------------------------------------------------------

def shard_channel_state(mesh: Mesh,
                        state: trk.ChannelState) -> list[trk.ChannelState]:
    """The host ledger split over the channel axis: one ChannelState per
    channel shard, in mesh order, each holding its rows (concatenating
    them gives back ``state``)."""
    c = int(np.asarray(state.active).shape[0])
    per = shard_rows(c, mesh)
    return [trk.ChannelState(*(np.asarray(f)[i * per:(i + 1) * per].copy()
                               for f in state))
            for i in range(mesh.shape[CHANNEL_AXIS])]


def _on(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def shard_fused_step(mesh: Mesh, step_fn):
    """A FusedTracker block step with channels sharded over the mesh's
    channel axis and the sample stream replicated: each shard's kernel
    is launched on its device on its own channel rows, with no exchange
    between shards.

    The per-channel operands split in mesh order: ``starts`` [C] (the
    windows layout's offsets), the replicas [C, ...] and the state
    [C, 128], and the static ``starts_host`` [C] of a single block (the
    seg and windows steps' too); the other statics (``starts_bound``,
    ``telem_mode``, ``k_epochs``, ...) pass through unchanged. The
    outputs are gathered onto the state's device: telemetry [T, C, cols]
    on dim 1, state [C, 128] on dim 0. B2's [C + 1] starts (the shared
    base last) do not split: the tracker turns the shared fetch off
    under a mesh, as the JAX package does.

    Returns a callable with the step's signature ``(block_re, block_im,
    starts, replicas, state, **statics)``."""
    devices = _channel_devices(mesh)

    def call(block_re, block_im, starts, reps, mat, **kw):
        c = mat.shape[0]
        per = shard_rows(c, mesh)
        if starts.shape[0] != c:
            raise ValueError(f"a channel-sharded step takes [C={c}] starts, "
                             f"got {tuple(starts.shape)} (the shared fetch "
                             "does not shard)")
        host = kw.pop("starts_host", None)
        streams: dict = {}
        telems, states = [], []
        for i, dev in enumerate(devices):
            rows = slice(i * per, (i + 1) * per)
            if host is not None:
                kw["starts_host"] = np.asarray(host)[rows]
            with _current(dev):
                if dev not in streams:
                    streams[dev] = (block_re.to(dev), block_im.to(dev))
                telem, st = step_fn(*streams[dev], starts[rows].to(dev),
                                    reps[rows].to(dev), mat[rows].to(dev),
                                    **kw)
            telems.append(telem.to(mat.device))
            states.append(st.to(mat.device))
        return torch.cat(telems, dim=1), torch.cat(states, dim=0)

    return call


def sharded_track_block(mesh: Mesh, params: trk.TrackParams, codes,
                        state: trk.ChannelState, block_re, block_im,
                        n_epochs: int, valid_len: Optional[int] = None,
                        graph: bool = True, timers: StageTimer | None = None
                        ) -> tuple[trk.ChannelState, trk.EpochTelemetry]:
    """track_block with channels sharded over the mesh's channel axis and
    the block replicated: each shard's ledger rows and code rows go to
    its device, ``track_block_device`` runs its epochs there (on the
    card, on the shard's CUDA graph), and the per-shard results are
    unpacked and concatenated in mesh order (the host ledger [C], the
    telemetry [T, C]). Every shard is queued before the first download.

    Shards of equal width on one card share one ``tracking.graph_key``
    and so one graph: each call copies its inputs into the graph's
    buffers and returns a copy of its result, so the shards' results
    stay apart. ``timers``: as in ``track_block``."""
    timer = timers if timers is not None else StageTimer()
    devices = _channel_devices(mesh)
    c = int(np.asarray(state.active).shape[0])
    per = shard_rows(c, mesh)
    codes = torch.as_tensor(codes, dtype=torch.float32)
    outs = []
    with timer.stage("track.launch"):
        for i, (dev, st) in enumerate(zip(devices,
                                          shard_channel_state(mesh, state))):
            with _current(dev):
                outs.append(trk.track_block_device(
                    params, codes[i * per:(i + 1) * per].to(dev), st,
                    _on(block_re, dev), _on(block_im, dev), n_epochs,
                    valid_len, graph))
    with timer.stage("track.wait"):
        outs = [o.cpu().numpy() for o in outs]
    with timer.stage("track.absorb"):
        parts = [trk.unpack_block(o, per, n_epochs) for o in outs]
        new_state = trk.ChannelState(*(
            np.concatenate(f) for f in zip(*(s for s, _ in parts))))
        telem = trk.EpochTelemetry(*(
            np.concatenate(f, axis=1) for f in zip(*(t for _, t in parts))))
    return new_state, telem


# ---------------------------------------------------------------------------
# PRN-sharded acquisition (channel axis)
# ---------------------------------------------------------------------------

def _gather_results(results, device) -> pcps.AcqResults:
    return pcps.AcqResults(*(torch.cat([f.to(device) for f in fields])
                             for fields in zip(*results)))


def sharded_pcps_search(mesh: Mesh, samples, code_ffts, carrier_freqs, *,
                        fs_hz: float, n_int: int,
                        threshold: float = 7.0) -> pcps.AcqResults:
    """PCPS with the PRN rows split over the channel axis: each shard
    runs ``pcps_search`` on its device on its rows of ``code_ffts``
    (the samples and the Doppler grid replicated), and the AcqResults
    fields are concatenated in PRN order on the mesh's home device."""
    devices = _channel_devices(mesh)
    code_ffts = torch.as_tensor(code_ffts)
    per = shard_rows(code_ffts.shape[0], mesh, "n_prn")
    results = []
    for i, dev in enumerate(devices):
        with _current(dev):
            results.append(pcps.pcps_search(
                torch.as_tensor(samples).to(dev),
                code_ffts[i * per:(i + 1) * per].to(dev),
                torch.as_tensor(carrier_freqs).to(dev), fs_hz=fs_hz,
                n_int=n_int, threshold=threshold))
    return _gather_results(results, mesh.home)


# ---------------------------------------------------------------------------
# time-sharded acquisition (time axis): the partial power cubes summed
# ---------------------------------------------------------------------------

def time_sharded_pcps_search(mesh: Mesh, samples, code_ffts, carrier_freqs,
                             *, fs_hz: float, n_int: int,
                             threshold: float = 7.0) -> pcps.AcqResults:
    """Each time shard integrates n_int / n_time code periods of the
    chunk ``samples`` [n_int * N] and the partial power cubes sum; then
    the detector runs on the whole cube.

    Shard t's Doppler ramp starts at global sample t * (n_int / n_time)
    * N (``pcps_power``'s ``sample_offset``), so the result is the
    unsharded search's up to the f32 order of the sums. The codes and
    the grid are replicated: time row t runs on its first device (the
    channel axis, as in the JAX package, shards nothing here). This
    process sums the partial cubes of the rows it holds in time order on
    its home device; when the mesh spans processes, ``torch.distributed.
    all_reduce`` then sums the processes' partial cubes (each process
    passes the whole chunk and computes only its rows)."""
    n_time = mesh.shape[TIME_AXIS]
    if n_int % n_time:
        raise ValueError(f"n_int={n_int} not divisible by time axis "
                         f"{n_time}")
    code_ffts = torch.as_tensor(code_ffts)
    n_local = n_int // n_time
    n_fft = code_ffts.shape[-1]
    samples = torch.as_tensor(samples)
    if samples.shape[-1] != n_int * n_fft:
        raise ValueError(f"need {n_int}x{n_fft} samples, got "
                         f"{samples.shape[-1]}")
    home = mesh.home
    freqs_home = torch.as_tensor(carrier_freqs).to(home)
    power = torch.zeros((code_ffts.shape[0], freqs_home.shape[0], n_fft),
                        dtype=torch.float32, device=home)
    for t in range(n_time):
        if not mesh.is_local(t, 0):
            continue
        dev = mesh.devices[t, 0]
        start = t * n_local * n_fft
        with _current(dev):
            part = pcps.pcps_power(
                samples[start:start + n_local * n_fft].to(dev),
                code_ffts.to(dev), freqs_home.to(dev), fs_hz=fs_hz,
                n_int=n_local, sample_offset=start)
        power = power + part.to(home)
    with _current(home):
        if mesh.spans_processes:
            torch.distributed.all_reduce(power)
        return pcps.detect(power, freqs_home, threshold)
