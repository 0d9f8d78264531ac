"""GPS L1 C/A: the Gold codes (IS-GPS-200 table 3-I) and the LNAV
message encoder, the benchmark's own copies (the generator renders the
stream with them, the reference decodes against them).

LNAV: 300-bit subframes of ten 30-bit words, Hamming parity chained by
D29*/D30*, words 2 and 10 ending in parity 00 so each subframe starts
uncomplemented (IS-GPS-200 20.3.3.1, 20.3.5.2).
"""
from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 1023
CODE_RATE_HZ = 1.023e6
CARRIER_HZ = 1_575_420_000.0
CODE_PERIOD_MS = 1
BIT_MS = 20                     # code periods per nav bit
SUBFRAME_BITS = 300
PREAMBLE01 = np.array([1, 0, 0, 0, 1, 0, 1, 1], np.uint8)

G2_DELAY_CHIPS = (
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251, 252, 254, 255, 256, 257, 258,
    469, 470, 471, 472, 473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862)

# data-bit indices (1..24) feeding parity bits D25..D30, and the seed bit
_PARITY_TAPS = (
    (29, (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23)),
    (30, (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24)),
    (29, (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22)),
    (30, (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23)),
    (30, (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24)),
    (29, (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24)),
)


def _lfsr(taps: tuple[int, ...]) -> np.ndarray:
    state = np.ones(10, np.uint8)
    out = np.empty(CODE_LENGTH, np.uint8)
    for i in range(CODE_LENGTH):
        out[i] = state[9]
        fb = 0
        for t in taps:
            fb ^= state[t - 1]
        state[1:] = state[:-1]
        state[0] = fb
    return out


@functools.lru_cache(maxsize=None)
def code(prn: int) -> np.ndarray:
    """The 1023-chip C/A code of ``prn`` (1-32) as int8 +-1."""
    g1 = _lfsr((10, 3))
    g2 = np.roll(_lfsr((10, 9, 8, 6, 3, 2)), G2_DELAY_CHIPS[prn - 1])
    return (2 * (g1 ^ g2).astype(np.int8) - 1).astype(np.int8)


def code_table(n_prn: int = 32) -> np.ndarray:
    return np.stack([code(p) for p in range(1, n_prn + 1)])


def sample_code(prn: int, fs_hz: float) -> np.ndarray:
    """The code sampled at ``fs`` over one period: round(fs * 1 ms)
    samples, chip floor(i * rate / fs) (nearest-chip sampling)."""
    n = int(round(fs_hz / (CODE_RATE_HZ / CODE_LENGTH)))
    idx = np.floor(np.arange(n, dtype=np.float64) * CODE_RATE_HZ / fs_hz)
    return code(prn)[idx.astype(np.int64) % CODE_LENGTH]


def parity(data24: np.ndarray, d29: int, d30: int) -> np.ndarray:
    out = np.empty(6, np.uint8)
    for k, (seed, taps) in enumerate(_PARITY_TAPS):
        v = d29 if seed == 29 else d30
        for t in taps:
            v ^= int(data24[t - 1])
        out[k] = v
    return out


def encode_subframe(subframe_id: int, tow_counts: int,
                    words: np.ndarray) -> np.ndarray:
    """300 on-air bits (0/1) of one subframe: TLM (preamble), HOW (TOW
    count of the next subframe, subframe id, the two t-bits solved for
    parity 00) and the data words 3..10 ``words`` [8, 24]; the previous
    subframe ended with parity 00."""
    src = np.zeros((10, 24), np.uint8)
    src[0, :8] = PREAMBLE01
    for i in range(17):
        src[1, i] = (tow_counts >> (16 - i)) & 1
    for i in range(3):
        src[1, 19 + i] = (subframe_id >> (2 - i)) & 1
    src[2:] = words
    out = np.zeros(SUBFRAME_BITS, np.uint8)
    d29 = d30 = 0
    for w in range(10):
        s = src[w].copy()
        if w in (1, 9):
            for b in range(4):
                s[22], s[23] = b >> 1, b & 1
                if not parity(s ^ d30, d29, d30)[4:].any():
                    break
        tx = s ^ d30
        par = parity(tx, d29, d30)
        out[w * 30:w * 30 + 24] = tx
        out[w * 30 + 24:(w + 1) * 30] = par
        d29, d30 = int(par[4]), int(par[5])
    return out


def _put(words: np.ndarray, parts, value: int) -> None:
    """Write ``value`` into (word 3..10, first bit 1..24, bits) pieces of
    ``words`` [8, 24], MSB piece first."""
    total = sum(n for _, _, n in parts)
    value &= (1 << total) - 1
    bits = [(value >> (total - 1 - i)) & 1 for i in range(total)]
    k = 0
    for w, b, n in parts:
        words[w - 3, b - 1:b - 1 + n] = bits[k:k + n]
        k += n


def ephemeris_words(rng: np.random.Generator) -> dict[int, np.ndarray]:
    """Subframes 1-3 data words of one broadcast ephemeris: every field
    a random value of its width, the issue of data (IODC's low 8 bits,
    IODE in subframes 2 and 3) the same, so a receiver assembles them."""
    words = {k: rng.integers(0, 2, (8, 24)).astype(np.uint8)
             for k in (1, 2, 3)}
    iode = int(rng.integers(0, 256))
    iodc = (int(rng.integers(0, 4)) << 8) | iode
    _put(words[1], [(3, 23, 2), (8, 1, 8)], iodc)
    _put(words[2], [(3, 1, 8)], iode)
    _put(words[3], [(10, 1, 8)], iode)
    return words


class LnavStream:
    """One satellite's endless LNAV bit stream (+-1 per 20 ms bit):
    subframe s (s = 0, 1, ...) has id (s + id0) % 5 + 1 and HOW TOW
    count tow0 + s + 1; subframes 1-3 carry this satellite's ephemeris,
    4 and 5 random words of (seed, PRN, s)."""

    def __init__(self, seed: int, prn: int, rng: np.random.Generator):
        self.seed, self.prn = seed, prn
        self.eph_words = ephemeris_words(rng)
        self.id0 = int(rng.integers(0, 5))
        self.tow0 = int(rng.integers(1000, 90_000))
        self._cache: dict[int, np.ndarray] = {}

    def subframe(self, s: int) -> tuple[int, int, np.ndarray]:
        """(subframe id, HOW TOW count, data words 3..10 [8, 24])."""
        sf_id = (s + self.id0) % 5 + 1
        if sf_id <= 3:
            words = self.eph_words[sf_id]
        else:
            words = np.random.default_rng(
                [self.seed, self.prn, s, 7]).integers(
                    0, 2, (8, 24)).astype(np.uint8)
        return sf_id, self.tow0 + s + 1, words

    def bits(self, first: int, count: int) -> np.ndarray:
        """+-1 int8 bits [first, first + count) of the stream."""
        out = np.empty(count, np.int8)
        i = 0
        while i < count:
            b = first + i
            s, off = divmod(b, SUBFRAME_BITS)
            if s not in self._cache:
                self._cache[s] = (2 * encode_subframe(*self.subframe(s))
                                  .astype(np.int8) - 1)
            take = min(count - i, SUBFRAME_BITS - off)
            out[i:i + take] = self._cache[s][off:off + take]
            i += take
        return out
