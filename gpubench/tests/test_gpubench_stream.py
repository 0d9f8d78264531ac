"""The generator: the same (seed, chunk) gives the same samples whatever
was made before; other seeds give other skies; reads across chunks."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench.harness.stream import ChunkStream, StreamSource, build_sky
from gpubench.signals import SIGNALS

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def _stream(traffic, seed, fs=2_048_000.0, chunk=51_200):
    t = json.loads((TRAFFIC / f"{traffic}.json").read_text())
    return ChunkStream(build_sky(t, seed), fs, chunk, seed, 16.0, "cpu")


def test_chunk_is_a_function_of_seed_and_index():
    a, b = _stream("open_sky", 2 ** 31 + 11), _stream("open_sky", 2 ** 31 + 11)
    b.render(0)
    b.render(5)
    for k in (3, 1):
        ra, ia = a.render(k)
        rb, ib = b.render(k)
        assert torch.equal(ra, rb) and torch.equal(ia, ib)
    assert ra.dtype == torch.int8


def test_other_seed_other_sky_and_noise():
    a, b = _stream("open_sky", 7), _stream("open_sky", 8)
    assert [s.doppler_hz for s in a.sats] != [s.doppler_hz for s in b.sats]
    assert not torch.equal(a.render(0)[0], b.render(0)[0])


def test_reads_cross_chunks_and_start_at_zero():
    s = _stream("open_sky", 3)
    src = StreamSource(s)
    re, im = src.read(80_000)                 # crosses the first chunk
    r8, _ = s.int8_range(0, 80_000)
    assert torch.equal(re, r8.float() / 16.0)
    z, _ = s.int8_range(-10, 5)
    assert torch.equal(z[:10], torch.zeros(10, dtype=torch.int8))
    src.stop = True
    assert src.read(10) is None


def test_sky_sizes_fixed_by_the_traffic():
    traffic = json.loads((TRAFFIC / "sparse_sky.json").read_text())
    skies = [build_sky(traffic, seed) for seed in (1, 2, 3)]
    for sats in skies:
        count = {}
        for s in sats:
            count[s.system] = count.get(s.system, 0) + 1
        assert count == {"gps_l1ca": 6, "galileo_e1b": 2, "beidou_b1i": 4,
                         "glonass_l1of": 2}
        glo = [s for s in sats if s.system == "glonass_l1of"]
        assert sorted(s.prn for s in glo) == [5, 10]
        assert all(s.prn == s.fdma_k + 8 for s in glo)
    # the sky's geometry is the traffic's (sky_seed), not the run's
    geometry = [[(s.prn, s.doppler_hz, s.amplitude, s.unit0) for s in sats]
                for sats in skies]
    assert geometry[0] == geometry[1] == geometry[2]


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_a_satellite_is_found_where_it_was_put(name):
    """One satellite alone: the samples correlate with its code at the
    code phase the generator put it at."""
    sig = SIGNALS[name]
    fs = 8_184_000.0
    traffic = {"satellites": [{"system": name, "prns": [3],
                               "doppler_hz": [0.0, 0.0],
                               "amplitude": [1.0, 1.0]}]}
    if name == "glonass_l1of":
        traffic["satellites"][0] = {"system": name, "channels": [0],
                                    "fdma_spacing_hz": 562_500.0,
                                    "doppler_hz": [0.0, 0.0],
                                    "amplitude": [1.0, 1.0]}
    sky = build_sky(traffic, 5)
    n0 = int(round(fs * sig.code_period_ms / 1000.0))
    st = ChunkStream(sky, fs, 4 * n0, 5, 16.0, "cpu", noise_power=1e-6)
    re, im = st.int8_range(0, n0)
    x = (re.double() + 1j * im.double()).numpy()
    code = sig.sample_code(sky[0].prn, fs).astype(np.float64)
    corr = np.abs(np.fft.ifft(np.fft.fft(x) * np.conj(np.fft.fft(code))))
    lag = int(np.argmax(corr))
    units = sky[0].unit0 % sig.units_per_code
    want = (-units / sig.unit_rate_hz * fs) % n0
    assert min(abs(lag - want), n0 - abs(lag - want)) <= 2
    assert corr.max() > 20 * np.median(corr)
