"""The benchmark's sample stream: a sky of satellites drawn from the
traffic file and the seed, rendered on the device chunk by chunk as
complex int8 I/Q.

A sample is the mean of the signal over its own interval (integrate and
dump): where a code chip or a subcarrier half-chip ends inside it, the
two are mixed by their shares of it. Every satellite carries its nav
message. Noise is complex Gaussian of unit power from a generator seeded
by (seed, chunk), so chunk k is the same whenever it is made: the
receiver's copy and the reference's.

The receiver reads the stream through ``StreamSource`` objects (one per
receiver branch, each at its own position); ``ChunkStream.prefetch``
renders the next chunk on a side stream of the card ahead of them.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..signals import SIGNALS

GENERATE_RANGE = "gpubench.generate"


@dataclasses.dataclass
class Satellite:
    system: str
    prn: int
    carrier_hz: float         # offset from the stream's centre (FDMA + Doppler)
    doppler_hz: float
    amplitude: float
    unit0: float              # rendering units elapsed at sample 0
    carrier_phase0: float     # cycles at sample 0
    nav: object
    fdma_k: int = 0


def _uniform(rng, lo_hi):
    lo, hi = lo_hi
    return float(rng.uniform(lo, hi))


def build_sky(traffic: dict, seed: int) -> list[Satellite]:
    """The traffic file's satellites for ``seed``: each group lists its
    PRNs (FDMA: its channels); Dopplers, amplitudes and code phases come
    from the traffic's ``sky_seed`` where it fixes the sky, else from
    the seed; carrier phases and nav contents from the seed."""
    rng = np.random.default_rng([traffic.get("sky_seed", seed), 1])
    run_rng = np.random.default_rng([seed, 6])
    sats = []
    for group in traffic["satellites"]:
        sig = SIGNALS[group["system"]]
        if "fdma_spacing_hz" in group:
            # FDMA: satellites are frequency channels k, reported as the
            # pseudo-PRN k + 8 (channels -7..6)
            ks = list(group["channels"])
            prns = [k + 8 for k in ks]
        else:
            prns = list(group["prns"])
            ks = [0] * len(prns)
        for prn, k in zip(prns, ks):
            dop = _uniform(rng, group["doppler_hz"])
            ups = sig.units_per_symbol
            sym0 = int(rng.integers(0, 300))
            sats.append(Satellite(
                system=group["system"], prn=int(prn),
                carrier_hz=k * group.get("fdma_spacing_hz", 0.0) + dop,
                doppler_hz=dop,
                amplitude=_uniform(rng, group["amplitude"]),
                unit0=sym0 * ups + float(rng.uniform(0, ups)),
                carrier_phase0=float(run_rng.uniform(0.0, 1.0)),
                nav=sig.nav(seed, int(prn), np.random.default_rng(
                    [seed, 2, len(sats)])),
                fdma_k=int(k)))
    return sats


def chunk_seed(seed: int, chunk: int) -> int:
    return int(np.random.SeedSequence([seed, 3, chunk]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class ChunkStream:
    """Chunks of ``chunk_len`` samples of the sky at ``fs_hz`` on
    ``device`` (int8 re, int8 im), made on demand and kept until
    ``release``d."""

    def __init__(self, sats, fs_hz, chunk_len, seed, int8_scale, device,
                 noise_power=1.0):
        self.sats, self.fs = sats, float(fs_hz)
        self.chunk_len, self.seed = int(chunk_len), int(seed)
        self.scale = float(int8_scale)
        self.noise_sigma = math.sqrt(noise_power / 2.0)
        self.device = torch.device(device)
        self.side = (torch.cuda.Stream(device=self.device)
                     if self.device.type == "cuda" else None)
        self.chunks: dict[int, tuple] = {}      # k -> (re, im, event)
        self.generated = 0

    # -- rendering ----------------------------------------------------
    def render(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Chunk ``k`` as two int8 tensors, made on the current stream."""
        dev, fs, n0 = self.device, self.fs, k * self.chunk_len
        n = torch.arange(n0, n0 + self.chunk_len, dtype=torch.float64,
                         device=dev)
        re = torch.zeros(self.chunk_len, dtype=torch.float32, device=dev)
        im = torch.zeros_like(re)
        for sat in self.sats:
            sig = SIGNALS[sat.system]
            rate = sig.unit_rate_hz * (1.0 + sat.doppler_hz / sig.carrier_hz)
            r = rate / fs
            ups = sig.units_per_symbol
            table = torch.as_tensor(sig.table(sat.prn), dtype=torch.float32,
                                    device=dev)
            length = table.shape[0]
            sec = (None if sig.secondary is None else torch.as_tensor(
                sig.secondary, dtype=torch.float32, device=dev))
            u = sat.unit0 + r * n
            kf = torch.floor(u)
            first = int(math.floor((sat.unit0 + r * n0) / ups))
            last = int(math.floor((sat.unit0 + r * (n0 + self.chunk_len))
                                  / ups)) + 2
            syms = torch.as_tensor(sat.nav.bits(first, last - first),
                                   dtype=torch.float32, device=dev)
            ki = kf.to(torch.int64)

            def signed(kk):
                v = table[kk % length] * syms[
                    torch.div(kk, ups, rounding_mode="floor") - first]
                if sec is not None:
                    v = v * sec[torch.div(kk, length, rounding_mode="floor")
                                % sec.shape[0]]
                return v
            w = torch.clamp((kf + 1.0 - u) / r, 0.0, 1.0).to(torch.float32)
            chips = signed(ki) * w + signed(ki + 1) * (1.0 - w)
            cyc = sat.carrier_phase0 + (sat.carrier_hz / fs) * n
            theta = ((cyc - torch.floor(cyc)) * (2.0 * math.pi)).to(
                torch.float32)
            amp = chips * sat.amplitude
            re += amp * torch.cos(theta)
            im += amp * torch.sin(theta)
        g = torch.Generator(device=dev)
        g.manual_seed(chunk_seed(self.seed, k))
        noise = torch.randn((2, self.chunk_len), generator=g, device=dev,
                            dtype=torch.float32) * self.noise_sigma
        out = []
        for x, z in ((re, noise[0]), (im, noise[1])):
            q = torch.round((x + z) * self.scale).clamp_(-127, 127)
            out.append(q.to(torch.int8))
        self.generated += 1
        return out[0], out[1]

    def prefetch(self, k: int) -> None:
        """Start making chunk ``k`` (on the side stream on the card)."""
        if k in self.chunks:
            return
        if self.side is None:
            self.chunks[k] = (*self.render(k), None)
            return
        self.side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.side), \
                torch.profiler.record_function(GENERATE_RANGE):
            re, im = self.render(k)
            ev = torch.cuda.Event()
            ev.record(self.side)
        self.chunks[k] = (re, im, ev)

    def get(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Chunk ``k``, usable on the current stream."""
        self.prefetch(k)
        re, im, ev = self.chunks[k]
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            re.record_stream(cur)
            im.record_stream(cur)
        return re, im

    def release(self, below: int) -> None:
        for k in [k for k in self.chunks if k < below]:
            del self.chunks[k]

    def int8_range(self, a: int, b: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Stream samples [a, b) as int8 (zeros before sample 0)."""
        parts_re, parts_im = [], []
        if a < 0:
            z = torch.zeros(min(b, 0) - a, dtype=torch.int8,
                            device=self.device)
            parts_re.append(z)
            parts_im.append(z)
            a = min(b, 0)
        while a < b:
            k, off = divmod(a, self.chunk_len)
            take = min(b - a, self.chunk_len - off)
            re, im = self.get(k)
            parts_re.append(re[off:off + take])
            parts_im.append(im[off:off + take])
            a += take
        cat = (lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs))
        return cat(parts_re), cat(parts_im)


class StreamSource:
    """One receiver branch's reader of a ChunkStream: ``read(n)`` gives
    the next n samples as planar f32 tensors on the device (int8 / the
    stream's scale), or None once ``stop`` is set."""

    def __init__(self, stream: ChunkStream):
        self.stream = stream
        self.fs_hz = stream.fs
        self.pos = 0
        self.stop = False

    def read(self, n: int):
        if self.stop:
            return None
        re8, im8 = self.stream.int8_range(self.pos, self.pos + n)
        self.pos += n
        inv = 1.0 / self.stream.scale
        return re8.to(torch.float32) * inv, im8.to(torch.float32) * inv
