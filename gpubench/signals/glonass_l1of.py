"""GLONASS L1OF: the 511-chip ranging code that every FDMA channel
shares, and the navigation string encoder, the benchmark's own copies.

A string is 2 s: 85 bits (the idle bit, the string number m, the data,
a Hamming (85, 77) check) relative-coded, each bit as two 10 ms
meander halves, then the 30-symbol time mark: 200 half-symbols, each
spanning 10 code periods.
"""
from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 511
CODE_RATE_HZ = 0.511e6
CARRIER_HZ = 1_602_000_000.0
CHANNEL_SPACING_HZ = 562_500.0
CODE_PERIOD_MS = 1
TIME_MARK = np.array([1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 0, 1,
                      0, 0, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0], np.uint8)
STRING_HALVES = 200

# (name, bits, scale, kind: u unsigned, s sign-magnitude), ICD table 4.5
FIELDS = {
    1: [("_rsvd", 2, 1, "u"), ("p1", 2, 1, "u"), ("tk_h", 5, 1, "u"),
        ("tk_m", 6, 1, "u"), ("tk_30", 1, 1, "u"),
        ("vx", 24, 2.0**-20, "s"), ("ax", 5, 2.0**-30, "s"),
        ("x", 27, 2.0**-11, "s")],
    2: [("bn", 3, 1, "u"), ("p2", 1, 1, "u"), ("tb", 7, 15 * 60.0, "u"),
        ("_rsvd", 5, 1, "u"), ("vy", 24, 2.0**-20, "s"),
        ("ay", 5, 2.0**-30, "s"), ("y", 27, 2.0**-11, "s")],
    3: [("p3", 1, 1, "u"), ("gamma_n", 11, 2.0**-40, "s"),
        ("_rsvd", 1, 1, "u"), ("p", 2, 1, "u"), ("ln", 1, 1, "u"),
        ("vz", 24, 2.0**-20, "s"), ("az", 5, 2.0**-30, "s"),
        ("z", 27, 2.0**-11, "s")],
    4: [("tau_n", 22, 2.0**-30, "s"), ("dtau_n", 5, 2.0**-30, "s"),
        ("en", 5, 1, "u"), ("_rsvd", 14, 1, "u"), ("p4", 1, 1, "u"),
        ("ft", 4, 1, "u"), ("_rsvd2", 3, 1, "u"), ("nt", 11, 1, "u"),
        ("n", 5, 1, "u"), ("m_type", 2, 1, "u")],
}


@functools.lru_cache(maxsize=None)
def code(prn: int = 0) -> np.ndarray:
    state = np.ones(9, np.uint8)
    out = np.empty(CODE_LENGTH, np.uint8)
    for i in range(CODE_LENGTH):
        out[i] = state[6]
        fb = state[8] ^ state[4]
        state[1:] = state[:-1]
        state[0] = fb
    return (2 * out.astype(np.int8) - 1).astype(np.int8)


def sample_code(prn: int, fs_hz: float) -> np.ndarray:
    n = int(round(fs_hz / (CODE_RATE_HZ / CODE_LENGTH)))
    idx = np.floor(np.arange(n, dtype=np.float64) * CODE_RATE_HZ / fs_hz)
    return code()[idx.astype(np.int64) % CODE_LENGTH]


def _codes() -> np.ndarray:
    codes, v = [], 3
    while len(codes) < 77:
        if bin(v).count("1") >= 2:
            codes.append(v)
        v += 1
    return np.array(codes, np.int64)


_CODES = _codes()


def hamming(data77: np.ndarray) -> np.ndarray:
    """77 data bits (transmit order) -> the 85-bit string."""
    d = np.asarray(data77, np.uint8)
    out = np.concatenate([d, np.zeros(8, np.uint8)])
    for k in range(7):
        mask = ((_CODES >> k) & 1).astype(np.uint8)
        out[84 - k] = int(np.bitwise_xor.reduce(d[::-1] & mask))
    out[77] = int(np.bitwise_xor.reduce(out[:77])) ^ int(
        np.bitwise_xor.reduce(out[78:]))
    return out


def line(string85: np.ndarray) -> np.ndarray:
    """85 bits -> 200 half-symbol levels (+-1)."""
    rel = np.bitwise_xor.accumulate(np.asarray(string85, np.uint8))
    lv = 1 - 2 * rel.astype(np.int8)
    halves = np.empty(170, np.int8)
    halves[0::2] = lv
    halves[1::2] = -lv
    return np.concatenate([halves, 2 * TIME_MARK.astype(np.int8) - 1])


def fields_of(m: int, data: np.ndarray) -> dict:
    """The field values a string decoder reads from the 72 bits after
    the string number."""
    out, pos = {}, 0
    for name, nbits, scale, kind in FIELDS.get(m, []):
        seg = data[pos:pos + nbits]
        if kind == "s":
            v = 0
            for b in seg[1:]:
                v = (v << 1) | int(b)
            out[name] = -v * scale if seg[0] else v * scale
        else:
            v = 0
            for b in seg:
                v = (v << 1) | int(b)
            out[name] = v * (scale if scale != 1 else 1)
        pos += nbits
    return out


class StringStream:
    """One satellite's endless string stream (+-1 per 10 ms half):
    string s has number (s + m0) % 15 + 1 and random content."""

    def __init__(self, seed: int, prn: int, rng: np.random.Generator):
        self.seed, self.prn = seed, prn
        self.m0 = int(rng.integers(0, 15))
        self._cache: dict[int, np.ndarray] = {}

    def string(self, s: int) -> tuple[int, np.ndarray]:
        """(m, the 72 bits after m)."""
        raw = np.random.default_rng([self.seed, self.prn, s, 17]).integers(
            0, 2, 72).astype(np.uint8)
        return (s + self.m0) % 15 + 1, raw

    def bits(self, first: int, count: int) -> np.ndarray:
        out = np.empty(count, np.int8)
        i = 0
        while i < count:
            s, off = divmod(first + i, STRING_HALVES)
            if s not in self._cache:
                m, raw = self.string(s)
                data = np.concatenate([np.zeros(1, np.uint8),
                                       np.array([(m >> (3 - k)) & 1
                                                 for k in range(4)],
                                                np.uint8), raw])
                self._cache[s] = line(hamming(data))
            take = min(count - i, STRING_HALVES - off)
            out[i:i + take] = self._cache[s][off:off + take]
            i += take
        return out
