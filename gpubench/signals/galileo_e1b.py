"""Galileo E1B: the 4092-chip primary codes with the BOC(1,1)
subcarrier, and the I/NAV message encoder, the benchmark's own copies.

The primary codes are the deterministic surrogate family that the port
uses where the ICD's memory-code tables are not loaded (seeded xorshift
bit streams): the benchmark's stream carries the codes the receiver
searches for. I/NAV: 2 s nominal pages of an even and an odd part, each
part 10 sync symbols and 240 symbols of the 114 info bits (and 6 tail
zeros) convolutionally encoded (K 7, rate 1/2, G2 inverted) and block
interleaved (30 x 8); the odd part carries the CRC-24Q of both.
"""
from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 4092
CODE_RATE_HZ = 1.023e6
CARRIER_HZ = 1_575_420_000.0
CODE_PERIOD_MS = 4
SYNC = np.array([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], np.uint8)
PAGE_PART = 250
_CRC24Q_POLY = 0x1864CFB
_G1, _G2 = 0o171, 0o133


def _xorshift_bits(seed: int, n: int) -> np.ndarray:
    mask = (1 << 64) - 1
    x = (seed * 2654435761 + 0x9E3779B97F4A7C15) & mask
    out = np.empty(n, np.int8)
    word = have = 0
    for i in range(n):
        if have == 0:
            x ^= x >> 12
            x = (x ^ (x << 25)) & mask
            x ^= x >> 27
            word = (x * 0x2545F4914F6CDD1D) & mask
            have = 64
        out[i] = 2 * (word & 1) - 1
        word >>= 1
        have -= 1
    return out


@functools.lru_cache(maxsize=None)
def code(prn: int) -> np.ndarray:
    """The E1B primary code of ``prn`` (the surrogate family), +-1."""
    return _xorshift_bits(prn * 2, CODE_LENGTH)


@functools.lru_cache(maxsize=None)
def half_chips(prn: int) -> np.ndarray:
    """The code times the BOC(1,1) subcarrier at half-chip resolution
    (+1 on each chip's first half)."""
    c = code(prn)
    out = np.empty(2 * CODE_LENGTH, np.int8)
    out[0::2] = c
    out[1::2] = -c
    return out


def sample_code(prn: int, fs_hz: float) -> np.ndarray:
    """One period sampled at ``fs`` (nearest chip, subcarrier sign by
    the half-chip)."""
    n = int(round(fs_hz / (CODE_RATE_HZ / CODE_LENGTH)))
    phase = np.arange(n, dtype=np.float64) * CODE_RATE_HZ / fs_hz
    idx = np.floor(phase).astype(np.int64) % CODE_LENGTH
    half = np.floor(phase * 2.0).astype(np.int64) & 1
    return (code(prn)[idx] * (1 - 2 * half)).astype(np.int8)


def _bits_of(value: int, n: int) -> np.ndarray:
    return np.array([(int(value) >> (n - 1 - i)) & 1 for i in range(n)],
                    np.uint8)


def crc24q(bits: np.ndarray) -> int:
    reg = 0
    for b in np.asarray(bits, np.uint8):
        reg ^= int(b) << 23
        reg <<= 1
        if reg & (1 << 24):
            reg ^= _CRC24Q_POLY
        reg &= 0xFFFFFF
    return reg


def _parity(x: int) -> int:
    return bin(x & 0x7F).count("1") & 1


def conv_encode(bits: np.ndarray) -> np.ndarray:
    out = np.empty(2 * bits.size, np.uint8)
    reg = 0
    for i, b in enumerate(np.asarray(bits, np.uint8)):
        reg = ((reg >> 1) | (int(b) << 6)) & 0x7F
        out[2 * i] = _parity(reg & _G1)
        out[2 * i + 1] = 1 - _parity(reg & _G2)
    return out


def page_part(info114: np.ndarray) -> np.ndarray:
    """114 info bits -> 250 +-1 symbols (sync, FEC, interleave)."""
    coded = conv_encode(np.concatenate([info114, np.zeros(6, np.uint8)]))
    inter = coded.reshape(30, 8).T.reshape(-1)
    return (2 * np.concatenate([SYNC, inter]).astype(np.int8) - 1)


def page(word128: np.ndarray) -> np.ndarray:
    """One nominal page (even part, then odd) of a 128-bit word, 500
    +-1 symbols."""
    even = np.concatenate([np.zeros(2, np.uint8), word128[:112]])
    odd_head = np.concatenate([np.array([1, 0], np.uint8), word128[112:],
                               np.zeros(64, np.uint8)])
    crc = crc24q(np.concatenate([even, odd_head]))
    odd = np.concatenate([odd_head, _bits_of(crc, 24), np.zeros(8, np.uint8)])
    return np.concatenate([page_part(even), page_part(odd)])


class InavStream:
    """One satellite's endless I/NAV symbol stream (one symbol per 4 ms
    code period): page k holds a 128-bit word of random content whose
    word type cycles 1..5 (the ephemeris and GST word types)."""

    def __init__(self, seed: int, prn: int, rng: np.random.Generator):
        self.seed, self.prn = seed, prn
        self.type0 = int(rng.integers(0, 5))
        self._cache: dict[int, np.ndarray] = {}

    def word(self, k: int) -> np.ndarray:
        w = np.random.default_rng([self.seed, self.prn, k, 11]).integers(
            0, 2, 128).astype(np.uint8)
        w[:6] = _bits_of((k + self.type0) % 5 + 1, 6)
        return w

    def bits(self, first: int, count: int) -> np.ndarray:
        out = np.empty(count, np.int8)
        i = 0
        while i < count:
            k, off = divmod(first + i, 2 * PAGE_PART)
            if k not in self._cache:
                self._cache[k] = page(self.word(k))
            take = min(count - i, 2 * PAGE_PART - off)
            out[i:i + take] = self._cache[k][off:off + take]
            i += take
        return out
