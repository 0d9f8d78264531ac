"""Slice 10 (ROADMAP A16) on the CPU: the port's Galileo I/NAV, BeiDou
D1 and GLONASS L1OF nav decoders and chains against the JAX package's.

  * tests/test_nav_messages.py's encode-then-decode cases, the same
    seeded bits, through both packages' codecs (conv code and Viterbi,
    interleaver, CRC-24Q, page parts, the I/NAV stream decoder; BCH,
    subframes, the NH-synced D1 chain; Hamming, strings and lines, the
    GLONASS chain at three half-symbol phases);
  * both packages' NavProcessor fed the same prompt arrays for each
    signal (two channels of a satellite broadcasting its genuine message,
    with noise, a Costas sign flip and an arbitrary epoch phase).

Tolerance: none. Both sides run the same numpy code on the same inputs,
so every output (decoded bits, ephemerides, anchor events, status) must
be equal exactly; each case also checks that the decode succeeded.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke

from gnss_sdr_tpu.nav import bds_d1 as j_bds  # noqa: E402
from gnss_sdr_tpu.nav import glonass_nav as j_gn  # noqa: E402
from gnss_sdr_tpu.nav import inav as j_inav  # noqa: E402
from gnss_sdr_tpu.nav.ephemeris import Ephemeris as JEphemeris  # noqa: E402
from gnss_sdr_tpu.receiver import navproc as j_navproc  # noqa: E402

from gnss_sdr_tpu_torch.models.constellation import get_signal  # noqa: E402
from gnss_sdr_tpu_torch.nav import bds_d1, glonass_nav as gn, inav  # noqa: E402
from gnss_sdr_tpu_torch.nav.ephemeris import Ephemeris  # noqa: E402
from gnss_sdr_tpu_torch.receiver import navproc  # noqa: E402

PKGS = {
    "jax": SimpleNamespace(inav=j_inav, bds=j_bds, gn=j_gn,
                           Ephemeris=JEphemeris, navproc=j_navproc),
    "port": SimpleNamespace(inav=inav, bds=bds_d1, gn=gn,
                            Ephemeris=Ephemeris, navproc=navproc),
}


def assert_same(a, b, path="out"):
    """a (JAX package) and b (port) equal exactly: arrays element for
    element, dataclasses of the same name field for field, containers
    item for item."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def truths(m):
    return chip_smoke.live_truths(m.gn, m.Ephemeris)


# --- the codec cases of tests/test_nav_messages.py ----------------------

def inav_conv(m):
    rng = np.random.default_rng(0)
    bits = np.concatenate([rng.integers(0, 2, 114).astype(np.uint8),
                           np.zeros(6, np.uint8)])
    sym = m.inav.conv_encode(bits)
    bad = sym.copy()
    bad[np.arange(10, 230, 20)] ^= 1
    out = (sym, m.inav.viterbi_decode(sym, 120),
           m.inav.viterbi_decode(bad, 120))
    assert np.array_equal(out[2], bits)
    return out


def inav_interleave(m):
    x = np.arange(240)
    return m.inav.interleave(x), m.inav.deinterleave(m.inav.interleave(x))


def inav_crc(m):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 196).astype(np.uint8)
    c = m.inav.crc24q(bits)
    bits[57] ^= 1
    assert m.inav.crc24q(bits) != c
    return c, m.inav.crc24q(bits)


def inav_page(m):
    rng = np.random.default_rng(2)
    info = rng.integers(0, 2, 114).astype(np.uint8)
    part = m.inav.encode_page_part(info)
    assert np.array_equal(m.inav.decode_page_part(part), info)
    return part, m.inav.decode_page_part(part)


def inav_stream(m):
    truth = truths(m)[0]
    stream = m.inav.encode_symbol_stream(truth, wn=1234, tow0_s=5000.0,
                                         n_pages=7)
    stream = np.concatenate([np.array([1, -1, 1], np.int8), -stream])
    epochs = np.arange(stream.size) + 1000
    dec = m.inav.InavDecoder(prn=truth.prn)
    words = []
    for k in range(0, stream.size, 37):
        words += dec.feed_array(stream[k:k + 37].astype(float),
                                epochs[k:k + 37])
    assert dec.word_count == 7 and dec.ephemeris is not None
    return words, dec.ephemeris, dec.assembler.gst, dec.synced


def bds_bch(m):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(30):
        data = rng.integers(0, 2, 11).astype(np.uint8)
        cw = m.bds.bch_encode(data)
        p = int(rng.integers(0, 15))
        cw2 = cw.copy()
        cw2[p] ^= 1
        assert np.array_equal(m.bds.bch_decode(cw2), data)
        out.append((cw, m.bds.bch_decode(cw), m.bds.bch_decode(cw2)))
    return out


def bds_subframe(m):
    truth = truths(m)[1]
    f = m.bds.ephemeris_fields(truth)
    out = []
    for fra in (1, 2, 3):
        sf = m.bds.encode_subframe(fra, 345600 + 6 * fra, f[fra])
        dec = m.bds.decode_subframe(sf)
        assert dec[0] == fra and dec[1] == 345600 + 6 * fra
        out.append((sf, dec))
    return out


def bds_chain(m):
    truth = truths(m)[1]
    rng = np.random.default_rng(4)
    bits = m.bds.encode_bit_stream(truth, sow0=345600, n_subframes=9)
    nh = m.bds.NH.astype(np.float64)
    prompts = np.repeat(bits, 20).astype(np.float64) * np.tile(nh, bits.size)
    prompts = -prompts * 1000.0
    prompts += rng.standard_normal(prompts.size) * 150.0
    epochs = np.arange(prompts.size) + 7
    chain = m.bds.BdsD1Chain(prn=truth.prn)
    events = []
    for k in range(0, prompts.size, 487):
        events += chain.feed_array(prompts[k:k + 487], epochs[k:k + 487])
    assert chain.count >= 8 and chain.ephemeris is not None
    return events, chain.ephemeris, chain.count, chain.status()


def glo_hamming(m):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(30):
        d = rng.integers(0, 2, 77).astype(np.uint8)
        s = m.gn.hamming_encode(d)
        p = int(rng.integers(0, 85))
        s2 = s.copy()
        s2[p] ^= 1
        assert np.array_equal(m.gn.hamming_decode(s2), d)
        out.append((s, m.gn.hamming_decode(s), m.gn.hamming_decode(s2)))
    return out


def glo_string(m):
    truth = truths(m)[2]
    f = m.gn.ephemeris_fields(truth, tk_s=11430.0)
    out = []
    for k in (1, 2, 3, 4):
        s = m.gn.encode_string(k, f[k])
        line = m.gn.encode_line(s)
        bits = m.gn.decode_line(line.astype(float))
        dec = m.gn.decode_string(bits)
        assert np.array_equal(bits, s) and dec[0] == k
        out.append((s, line, bits, dec))
    return out


def glo_chain(m, phase):
    truth = truths(m)[2]
    rng = np.random.default_rng(6)
    stream = m.gn.encode_bit_stream(truth, tk_s=11430.0, n_strings=9)
    prompts = np.repeat(stream, 10).astype(np.float64) * -800.0
    prompts += rng.standard_normal(prompts.size) * 120.0
    epochs = np.arange(prompts.size) + phase
    chain = m.gn.GlonassNavChain(prn=truth.prn)
    events = []
    for k in range(0, prompts.size, 333):
        events += chain.feed_array(prompts[k:k + 333], epochs[k:k + 333])
    assert chain._half_phase == phase % 10 and chain.ephemeris is not None
    return events, chain.ephemeris, chain._half_phase, chain.status()


CODEC_CASES = {
    "inav_conv": inav_conv, "inav_interleave": inav_interleave,
    "inav_crc": inav_crc, "inav_page": inav_page,
    "inav_stream": inav_stream, "bds_bch": bds_bch,
    "bds_subframe": bds_subframe, "bds_chain": bds_chain,
    "glo_hamming": glo_hamming, "glo_string": glo_string,
    "glo_chain_phase0": lambda m: glo_chain(m, 0),
    "glo_chain_phase3": lambda m: glo_chain(m, 3),
    "glo_chain_phase9": lambda m: glo_chain(m, 9),
}


@pytest.mark.parametrize("case", list(CODEC_CASES))
def test_codec_equals_jax(case):
    assert_same(CODEC_CASES[case](PKGS["jax"]),
                CODEC_CASES[case](PKGS["port"]))


# --- the NavProcessor chains ---------------------------------------------

def _prompt_stream(signal, m):
    """Per-epoch prompt signs of one satellite broadcasting its genuine
    message (the scenes of tests/test_nav_live_multi.py; BeiDou with one
    subframe more, so the last ephemeris subframe ends inside the fed
    blocks), as
    models/signal.py modulates it: the data symbol of each epoch times
    the secondary code chip."""
    spec = get_signal(signal)
    gal, bds, glo = truths(m)
    if signal == "galileo_e1b":
        bits = m.inav.encode_symbol_stream(gal, wn=gal.week,
                                           tow0_s=432_000.0, n_pages=7,
                                           order=[5, 1, 2, 3, 4])
    elif signal == "beidou_b1i":
        bits = m.bds.encode_bit_stream(bds, sow0=345_600, n_subframes=5,
                                       order=[5, 1, 2, 3, 4])
    else:
        bits = m.gn.encode_bit_stream(glo, tk_s=11_430.0, n_strings=6,
                                      order=[15, 1, 2, 3, 4])
    n = bits.size * spec.symbols_per_bit
    e = np.arange(n)
    out = bits[(e // spec.symbols_per_bit) % bits.size].astype(np.float64)
    if spec.secondary_code is not None:
        out *= spec.secondary_code[e % spec.secondary_code.size]
    return spec, out


# (channel, prn, amplitude: its sign the Costas ambiguity, epoch lead)
NAV_CHANNELS = {"galileo_e1b": [(0, 11, 900.0, 0), (2, 11, -700.0, 3)],
                "beidou_b1i": [(0, 8, 1000.0, 0), (1, 8, -800.0, 7)],
                "glonass_l1of": [(0, 10, -800.0, 0), (3, 10, 900.0, 4)]}
NAV_BLOCK = 250                     # epochs per fed block


def _telemetry(signal, seed=11):
    """Blocks of [NAV_BLOCK, 4] telemetry (the fields NavProcessor reads)
    carrying NAV_CHANNELS' prompts with noise; the channels start
    ``lead`` epochs into the message at their own sample offsets."""
    spec, sym = _prompt_stream(signal, PKGS["port"])
    rng = np.random.default_rng(seed)
    c = 4
    n_ep = sym.size - 10
    n0 = 4092 * spec.code_period_ms
    blocks = []
    for b0 in range(0, n_ep - NAV_BLOCK + 1, NAV_BLOCK):
        t = np.arange(b0, b0 + NAV_BLOCK)
        i_p = np.zeros((NAV_BLOCK, c))
        processed = np.zeros((NAV_BLOCK, c), bool)
        for ch, _, amp, lead in NAV_CHANNELS[signal]:
            i_p[:, ch] = amp * sym[t + lead] + rng.standard_normal(
                NAV_BLOCK) * 120.0
            processed[:, ch] = True
        blocks.append(SimpleNamespace(
            processed=processed, i_p=i_p.astype(np.float32),
            epoch_index=np.repeat(t[:, None], c, 1).astype(np.int64),
            start_offset=(np.arange(NAV_BLOCK)[:, None] * n0
                          + 100 * np.arange(c)[None, :]).astype(np.int64),
            chip_phase=np.full((NAV_BLOCK, c), 0.25, np.float32),
            carr_freq=np.full((NAV_BLOCK, c), 1234.5, np.float32)))
    return spec, blocks


@pytest.mark.parametrize("signal", list(NAV_CHANNELS))
def test_nav_processor_equals_jax(signal):
    spec, blocks = _telemetry(signal)
    procs = {k: m.navproc.NavProcessor(4_092_000.0, spec.code_period_s,
                                       spec.code_length_chips,
                                       signal=signal)
             for k, m in PKGS.items()}
    for proc in procs.values():
        for ch, prn, _, _ in NAV_CHANNELS[signal]:
            proc.open_channel(ch, prn)
    for k, telem in enumerate(blocks):
        for proc in procs.values():
            proc.feed_block(telem, k * 10_000_000)
    a, b = procs["jax"], procs["port"]
    assert_same(a.status(), b.status())
    assert_same(a.ephemerides, b.ephemerides)
    assert_same(a.latest, b.latest)
    for ch in a.channels:
        assert_same(a.channels[ch].anchor, b.channels[ch].anchor,
                    f"channel {ch} anchor")
    prn = NAV_CHANNELS[signal][0][1]
    assert prn in b.ephemerides, b.status()
    assert all(s["frame_locked"] and s["tow_anchor_s"] is not None
               for s in b.status().values()), b.status()


@pytest.mark.parametrize("signal", list(NAV_CHANNELS) + ["galileo_e1c"])
def test_make_chain_equals_jax(signal):
    """make_chain builds the same chain class for every non-GPS signal
    (E1C, the pilot, takes E1B's I/NAV chain, as in the JAX package)."""
    a = j_navproc.make_chain(signal, 7)
    b = navproc.make_chain(signal, 7)
    assert type(a).__name__ == type(b).__name__
    assert_same(a.status(), b.status())
    assert type(b).__module__.startswith("gnss_sdr_tpu_torch.")
