"""BeiDou B1I: the 2046-chip ranging codes, the 20-chip Neumann-Hoffman
secondary code, and the D1 message encoder, the benchmark's own copies.

D1: 300-bit subframes (6 s at 50 bit/s) of ten 30-bit words: the
11-bit preamble, then 209 payload bits (FraID, SOW, fields) in BCH(15,
11) blocks, the words after the first with two blocks bit-interleaved.
Each bit spans 20 code periods, each period times one NH chip.
"""
from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 2046
CODE_RATE_HZ = 2.046e6
CARRIER_HZ = 1_561_098_000.0
CODE_PERIOD_MS = 1
NH = np.array([2 * b - 1 for b in (0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0,
                                   1, 0, 0, 1, 1, 1, 0)], np.int8)
PREAMBLE01 = np.array([1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0], np.uint8)
SUBFRAME_BITS = 300
PI_ICD = 3.1415926535898
PHASE_TAPS = (
    (1, 3), (1, 4), (1, 5), (1, 6), (1, 8), (1, 9), (1, 10), (1, 11),
    (2, 7), (3, 4), (3, 5), (3, 6), (3, 8), (3, 9), (3, 10), (3, 11),
    (4, 5), (4, 6), (4, 8), (4, 9), (4, 10), (4, 11), (5, 6), (5, 8),
    (5, 9), (5, 10), (5, 11), (6, 8), (6, 9), (6, 10), (6, 11), (8, 9),
    (8, 10), (8, 11), (9, 10), (9, 11), (10, 11),
)
_SEED = np.array([0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0], np.uint8)

# (name, bits, scale, signed) after FraID and SOW, BDS-SIS-ICD tables
FIELDS = {
    1: [("sat_h1", 1, 1, False), ("aodc", 5, 1, False),
        ("urai", 4, 1, False), ("wn", 13, 1, False),
        ("t_oc", 17, 8.0, False), ("t_gd", 10, 1e-10, True),
        ("t_gd2", 10, 1e-10, True), ("alpha0", 8, 2.0**-30, True),
        ("alpha1", 8, 2.0**-27, True), ("alpha2", 8, 2.0**-24, True),
        ("alpha3", 8, 2.0**-24, True), ("beta0", 8, 2.0**11, True),
        ("beta1", 8, 2.0**14, True), ("beta2", 8, 2.0**16, True),
        ("beta3", 8, 2.0**16, True), ("a_f2", 11, 2.0**-66, True),
        ("a_f0", 24, 2.0**-33, True), ("a_f1", 22, 2.0**-50, True),
        ("aode", 5, 1, False)],
    2: [("delta_n", 16, 2.0**-43 * PI_ICD, True),
        ("c_uc", 18, 2.0**-31, True), ("m0", 32, 2.0**-31 * PI_ICD, True),
        ("e", 32, 2.0**-33, False), ("c_us", 18, 2.0**-31, True),
        ("c_rc", 18, 2.0**-6, True), ("c_rs", 18, 2.0**-6, True),
        ("sqrt_a", 32, 2.0**-19, False), ("t_oe_msb", 2, 1, False)],
    3: [("t_oe_lsb", 15, 1, False), ("i0", 32, 2.0**-31 * PI_ICD, True),
        ("c_ic", 18, 2.0**-31, True),
        ("omega_dot", 24, 2.0**-43 * PI_ICD, True),
        ("c_is", 18, 2.0**-31, True), ("idot", 14, 2.0**-43 * PI_ICD, True),
        ("omega0", 32, 2.0**-31 * PI_ICD, True),
        ("omega", 32, 2.0**-31 * PI_ICD, True), ("_rev", 1, 1, False)],
}


def _lfsr(taps=None) -> np.ndarray:
    state = _SEED.copy()
    out = np.empty(CODE_LENGTH, np.uint8)
    for i in range(CODE_LENGTH):
        if taps is None:
            out[i] = state[10]
            fb = (state[0] ^ state[6] ^ state[7] ^ state[8] ^ state[9]
                  ^ state[10])
        else:
            out[i] = state[taps[0] - 1] ^ state[taps[1] - 1]
            fb = (state[0] ^ state[1] ^ state[2] ^ state[3] ^ state[4]
                  ^ state[7] ^ state[8] ^ state[10])
        state[1:] = state[:-1]
        state[0] = fb
    return out


@functools.lru_cache(maxsize=None)
def code(prn: int) -> np.ndarray:
    g = _lfsr() ^ _lfsr(PHASE_TAPS[prn - 1])
    return (2 * g.astype(np.int8) - 1).astype(np.int8)


def sample_code(prn: int, fs_hz: float) -> np.ndarray:
    n = int(round(fs_hz / (CODE_RATE_HZ / CODE_LENGTH)))
    idx = np.floor(np.arange(n, dtype=np.float64) * CODE_RATE_HZ / fs_hz)
    return code(prn)[idx.astype(np.int64) % CODE_LENGTH]


def _bits_of(value: int, n: int) -> np.ndarray:
    return np.array([(int(value) >> (n - 1 - i)) & 1 for i in range(n)],
                    np.uint8)


def bch(data11: np.ndarray) -> np.ndarray:
    reg = 0
    for b in np.asarray(data11, np.uint8):
        fb = int(b) ^ ((reg >> 3) & 1)
        reg = (reg << 1) & 0xE
        if fb:
            reg ^= 0b0011
    return np.concatenate([data11, _bits_of(reg, 4)])


def subframe(fra_id: int, sow: int, raw: np.ndarray) -> np.ndarray:
    """300 on-air bits (0/1): ``raw`` the 186 payload bits after FraID
    and SOW."""
    payload = np.concatenate([_bits_of(fra_id, 3), _bits_of(sow >> 12, 8),
                              _bits_of(sow & 0xFFF, 12), raw])
    out = np.zeros(SUBFRAME_BITS, np.uint8)
    out[0:11] = PREAMBLE01
    out[15:30] = bch(payload[0:11])
    for w in range(9):
        d = payload[11 + 22 * w:11 + 22 * (w + 1)]
        word = np.empty(30, np.uint8)
        word[0::2] = bch(d[:11])
        word[1::2] = bch(d[11:])
        out[30 * (w + 1):30 * (w + 2)] = word
    return out


def fields_of(fra_id: int, raw: np.ndarray) -> dict:
    """The field values a D1 decoder reads from ``raw``."""
    out, pos = {}, 0
    for name, nbits, scale, signed in FIELDS.get(fra_id, []):
        v = 0
        for b in raw[pos:pos + nbits]:
            v = (v << 1) | int(b)
        if signed and raw[pos]:
            v -= 1 << nbits
        out[name] = v * scale if scale != 1 else v
        pos += nbits
    return out


class D1Stream:
    """One satellite's endless D1 bit stream (+-1, 50 bit/s): subframe
    s has FraID (s + id0) % 5 + 1 and SOW sow0 + 6 s, random content."""

    def __init__(self, seed: int, prn: int, rng: np.random.Generator):
        self.seed, self.prn = seed, prn
        self.id0 = int(rng.integers(0, 5))
        self.sow0 = 6 * int(rng.integers(100, 90_000))
        self._cache: dict[int, np.ndarray] = {}

    def subframe(self, s: int) -> tuple[int, int, np.ndarray]:
        raw = np.random.default_rng([self.seed, self.prn, s, 13]).integers(
            0, 2, 186).astype(np.uint8)
        return (s + self.id0) % 5 + 1, self.sow0 + 6 * s, raw

    def bits(self, first: int, count: int) -> np.ndarray:
        out = np.empty(count, np.int8)
        i = 0
        while i < count:
            s, off = divmod(first + i, SUBFRAME_BITS)
            if s not in self._cache:
                self._cache[s] = 2 * subframe(*self.subframe(s)).astype(
                    np.int8) - 1
            take = min(count - i, SUBFRAME_BITS - off)
            out[i:i + take] = self._cache[s][off:off + take]
            i += take
        return out
