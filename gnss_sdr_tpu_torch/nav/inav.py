"""Galileo E1B I/NAV message: encode + decode (host-side;
counterpart of ``gnss_sdr_tpu/nav/inav.py``, the same code).

Beyond-reference capability: the reference claims Galileo support
(reference README.md:2) but contains no Galileo code at all — no codes,
no FEC, no page layer. This implements the full I/NAV E1B chain per the
Galileo OS SIS ICD (issue 2.0):

  symbols (250 sym/s) -> page-part sync (10-symbol pattern 0101100000)
  -> block deinterleave (30 columns x 8 rows, written column-wise,
  read row-wise) -> rate-1/2 K=7 convolutional decode (G1=171o,
  G2=133o with the G2 branch inverted, 6 tail bits) -> even/odd page
  pairing -> CRC-24Q -> 128-bit words -> word types 1-5 ->
  Keplerian ephemeris + GST (WN, TOW).

The encoder is the exact inverse and serves as the test oracle and the
scene simulator's bit source (models/signal.py modulates the returned
+/-1 symbol stream, one symbol per 4 ms code epoch).

Timing convention: the TOW in word type 5 is the GST at the leading
edge of the first sync symbol of the EVEN page part of the nominal page
carrying the word (ICD section 5.1.2's page-start reference). The
decoder reports that symbol index so the receiver can pin transmit
time to a sample.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .ephemeris import Ephemeris

SYNC = np.array([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], dtype=np.uint8)
SYNC_PM = (2 * SYNC.astype(np.int8) - 1)
PAGE_SYMBOLS = 250          # one page part: 10 sync + 240 coded
CODED_SYMBOLS = 240
PAGE_BITS = 120             # after rate-1/2 decode (incl. 6 tail zeros)
INFO_BITS = 114
INTER_COLS = 30
INTER_ROWS = 8

# CRC-24Q (poly per ICD annex; same polynomial as RTCM/SBAS)
_CRC24Q_POLY = 0x1864CFB


def crc24q(bits: np.ndarray) -> int:
    """CRC-24Q over a 0/1 bit array (MSB-first)."""
    reg = 0
    for b in np.asarray(bits, dtype=np.uint8):
        reg ^= int(b) << 23
        reg <<= 1
        if reg & (1 << 24):
            reg ^= _CRC24Q_POLY
        reg &= 0xFFFFFF
    return reg


# ---------------------------------------------------------------------------
# Convolutional code (K=7, rate 1/2, G1=171o, G2=133o, G2 inverted)
# ---------------------------------------------------------------------------

_G1 = 0o171
_G2 = 0o133


def _parity6(x: np.ndarray) -> np.ndarray:
    x = x & 0x7F
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return x & 1


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """Encode 0/1 bits -> 2n symbols (G1 then inverted G2 per bit)."""
    bits = np.asarray(bits, dtype=np.uint8)
    out = np.empty(2 * bits.size, dtype=np.uint8)
    reg = 0
    for i, b in enumerate(bits):
        reg = ((reg >> 1) | (int(b) << 6)) & 0x7F
        out[2 * i] = _parity6(np.uint8(reg & _G1))
        out[2 * i + 1] = 1 - _parity6(np.uint8(reg & _G2))
    return out


def _branch_tables():
    """Per-state expected symbol pair for input bit 0/1 (64 states).

    State s_t = reg_t >> 1 (the 6 persisting register bits after a
    step); consuming bit b gives reg_{t+1} = s_t | (b << 6) and
    s_{t+1} = (s_t >> 1) | (b << 5), matching conv_encode exactly."""
    states = np.arange(64)
    tab = np.zeros((2, 64, 2), dtype=np.uint8)
    for b in (0, 1):
        reg = (states | (b << 6)) & 0x7F
        tab[b, :, 0] = _parity6(reg & _G1)
        tab[b, :, 1] = 1 - _parity6(reg & _G2)
    return tab


_BRANCH = _branch_tables()
# next state after consuming input bit b from state s (same recurrence
# as conv_encode: reg' = (reg >> 1) | (b << 6), state = low 6 bits of
# the *next* shift -> here state encodes the register's low 6 bits
_NEXT = np.zeros((2, 64), dtype=np.int64)
for _b in (0, 1):
    _NEXT[_b] = ((np.arange(64) >> 1) | (_b << 5)) & 0x3F


def viterbi_decode(symbols: np.ndarray, n_bits: int) -> np.ndarray:
    """Hard-decision Viterbi over +/-1 (or 0/1) symbols -> n_bits bits.

    Tail-terminated: the path ending in state 0 wins (the encoder
    appends 6 zero tail bits). Vectorized over the 64 states.
    """
    sym = np.asarray(symbols)
    if sym.dtype != np.uint8:
        sym = (sym > 0).astype(np.uint8)
    sym = sym.reshape(n_bits, 2)

    # path metric per state; big init except state 0
    pm = np.full(64, 1 << 30, dtype=np.int64)
    pm[0] = 0
    bp = np.zeros((n_bits, 64), dtype=np.uint8)   # winning input bit
    prev = np.zeros((n_bits, 64), dtype=np.int64)  # predecessor state
    states = np.arange(64)
    for t in range(n_bits):
        # candidate transitions: from every state s with bit b to
        # next state _NEXT[b, s]
        cost = np.zeros((2, 64), dtype=np.int64)
        for b in (0, 1):
            d = (_BRANCH[b, :, 0] != sym[t, 0]).astype(np.int64) + (
                _BRANCH[b, :, 1] != sym[t, 1]
            )
            cost[b] = pm + d
        new_pm = np.full(64, 1 << 30, dtype=np.int64)
        for b in (0, 1):
            ns = _NEXT[b]
            better = cost[b] < new_pm[ns]
            # scatter-min: np.minimum.at handles duplicate ns
            np.minimum.at(new_pm, ns, cost[b])
            # recompute winners after the reduce
        for b in (0, 1):
            ns = _NEXT[b]
            win = cost[b] == new_pm[ns]
            bp[t, ns[win]] = b
            prev[t, ns[win]] = states[win]
        pm = new_pm
    # trace back from state 0 (tail-terminated)
    s = 0
    bits = np.zeros(n_bits, dtype=np.uint8)
    for t in range(n_bits - 1, -1, -1):
        bits[t] = bp[t, s]
        s = int(prev[t, s])
    return bits


# ---------------------------------------------------------------------------
# Interleaver
# ---------------------------------------------------------------------------

def interleave(symbols: np.ndarray) -> np.ndarray:
    """Write column-wise into 30 cols x 8 rows, read row-wise."""
    return (
        np.asarray(symbols)
        .reshape(INTER_COLS, INTER_ROWS)
        .T.reshape(-1)
    )


def deinterleave(symbols: np.ndarray) -> np.ndarray:
    return (
        np.asarray(symbols)
        .reshape(INTER_ROWS, INTER_COLS)
        .T.reshape(-1)
    )


# ---------------------------------------------------------------------------
# Page parts / words
# ---------------------------------------------------------------------------

def _bits_of(value: int, n: int) -> np.ndarray:
    return np.array(
        [(int(value) >> (n - 1 - i)) & 1 for i in range(n)], dtype=np.uint8
    )


def _uint(bits: np.ndarray) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def _sint(bits: np.ndarray) -> int:
    v = _uint(bits)
    if bits[0]:
        v -= 1 << len(bits)
    return v


def encode_page_part(info114: np.ndarray) -> np.ndarray:
    """114 info bits -> 250 on-air +/-1 symbols (sync + FEC + interleave)."""
    bits = np.concatenate([np.asarray(info114, np.uint8),
                           np.zeros(6, np.uint8)])
    coded = conv_encode(bits)
    inter = interleave(coded)
    sym01 = np.concatenate([SYNC, inter])
    return (2 * sym01.astype(np.int8) - 1)


def decode_page_part(symbols250) -> Optional[np.ndarray]:
    """250 +/-1 symbols -> 114 info bits, or None if sync mismatches."""
    s = np.asarray(symbols250)
    if not np.array_equal((s[:10] > 0).astype(np.int8) * 2 - 1, SYNC_PM):
        return None
    coded = deinterleave((s[10:] > 0).astype(np.uint8))
    bits = viterbi_decode(coded, PAGE_BITS)
    return bits[:INFO_BITS]


@dataclasses.dataclass
class InavWord:
    word_type: int
    data: np.ndarray          # [128] uint8 word bits (incl. the type)
    even_page_index: int      # absolute symbol index of the even half
    even_page_epoch: Optional[int] = None  # tracking epoch of that symbol


def build_page(word128: np.ndarray, seq_tail: int = 0
               ) -> tuple[np.ndarray, np.ndarray]:
    """One nominal page: (even 114 bits, odd 114 bits) with CRC."""
    w = np.asarray(word128, np.uint8)
    even = np.concatenate([
        np.array([0, 0], np.uint8),      # even/odd=0, page type=nominal
        w[:112],
    ])
    odd_head = np.concatenate([
        np.array([1, 0], np.uint8),      # even/odd=1, page type=nominal
        w[112:128],
        _bits_of(seq_tail, 64),          # reserved1 + SAR + spare fields
    ])
    crc = crc24q(np.concatenate([even, odd_head]))
    odd = np.concatenate([odd_head, _bits_of(crc, 24), np.zeros(8, np.uint8)])
    return even, odd


def parse_page(even114: np.ndarray, odd114: np.ndarray
               ) -> Optional[np.ndarray]:
    """Validate CRC + even/odd flags; return the 128-bit word."""
    even = np.asarray(even114, np.uint8)
    odd = np.asarray(odd114, np.uint8)
    if even[0] != 0 or odd[0] != 1:
        return None
    if crc24q(np.concatenate([even, odd[:82]])) != _uint(odd[82:106]):
        return None
    return np.concatenate([even[2:114], odd[2:18]])


# ---------------------------------------------------------------------------
# Word types 1-5 (ephemeris + GST), ICD tables 39-44 layouts
# ---------------------------------------------------------------------------

PI_ICD = 3.1415926535898


def encode_word(eph: Ephemeris, word_type: int, iod_nav: int = 1,
                wn: int = 0, tow_s: float = 0.0) -> np.ndarray:
    """128-bit I/NAV word for types 1-5 from a Keplerian ephemeris."""
    def r(x, scale):
        return int(round(x / scale))

    p = [_bits_of(word_type, 6)]
    if word_type == 1:
        p += [_bits_of(iod_nav, 10),
              _bits_of(r(eph.t_oe, 60.0), 14),
              _bits_of(r(eph.m0, 2.0**-31 * PI_ICD) & 0xFFFFFFFF, 32),
              _bits_of(r(eph.e, 2.0**-33), 32),
              _bits_of(r(eph.sqrt_a, 2.0**-19), 32),
              np.zeros(2, np.uint8)]
    elif word_type == 2:
        p += [_bits_of(iod_nav, 10),
              _bits_of(r(eph.omega0, 2.0**-31 * PI_ICD) & 0xFFFFFFFF, 32),
              _bits_of(r(eph.i0, 2.0**-31 * PI_ICD) & 0xFFFFFFFF, 32),
              _bits_of(r(eph.omega, 2.0**-31 * PI_ICD) & 0xFFFFFFFF, 32),
              _bits_of(r(eph.idot, 2.0**-43 * PI_ICD) & 0x3FFF, 14),
              np.zeros(2, np.uint8)]
    elif word_type == 3:
        p += [_bits_of(iod_nav, 10),
              _bits_of(r(eph.omega_dot, 2.0**-43 * PI_ICD) & 0xFFFFFF, 24),
              _bits_of(r(eph.delta_n, 2.0**-43 * PI_ICD) & 0xFFFF, 16),
              _bits_of(r(eph.c_uc, 2.0**-29) & 0xFFFF, 16),
              _bits_of(r(eph.c_us, 2.0**-29) & 0xFFFF, 16),
              _bits_of(r(eph.c_rc, 2.0**-5) & 0xFFFF, 16),
              _bits_of(r(eph.c_rs, 2.0**-5) & 0xFFFF, 16),
              _bits_of(eph.ura & 0xFF, 8)]          # SISA index
    elif word_type == 4:
        p += [_bits_of(iod_nav, 10),
              _bits_of(eph.prn, 6),
              _bits_of(r(eph.c_ic, 2.0**-29) & 0xFFFF, 16),
              _bits_of(r(eph.c_is, 2.0**-29) & 0xFFFF, 16),
              _bits_of(r(eph.t_oc, 60.0), 14),
              _bits_of(r(eph.a_f0, 2.0**-34) & 0x7FFFFFFF, 31),
              _bits_of(r(eph.a_f1, 2.0**-46) & 0x1FFFFF, 21),
              _bits_of(r(eph.a_f2, 2.0**-59) & 0x3F, 6),
              np.zeros(2, np.uint8)]
    elif word_type == 5:
        p += [np.zeros(11 + 11 + 14 + 5, np.uint8),   # iono (unused here)
              _bits_of(r(eph.t_gd, 2.0**-32) & 0x3FF, 10),  # BGD E1/E5a
              _bits_of(r(eph.t_gd, 2.0**-32) & 0x3FF, 10),  # BGD E1/E5b
              _bits_of(eph.health & 0x3, 2),   # E5b HS
              _bits_of(eph.health & 0x3, 2),   # E1B HS
              np.zeros(2, np.uint8),           # DVS flags
              _bits_of(wn, 12),
              _bits_of(int(round(tow_s)), 20),
              np.zeros(23, np.uint8)]
    else:
        raise ValueError(f"unsupported I/NAV word type {word_type}")
    out = np.concatenate(p)
    assert out.size == 128, (word_type, out.size)
    return out


@dataclasses.dataclass
class GstTime:
    wn: int
    tow_s: float
    even_page_index: int     # absolute symbol index the TOW stamps
    even_page_epoch: Optional[int] = None  # tracking epoch of that symbol


class InavAssembler:
    """Collect words 1-4 with consistent IODnav into an Ephemeris.

    Word 5 provides GST (WN/TOW) and BGD/health; returns the ephemeris
    once words 1-4 agree on IODnav (the Galileo analogue of the LNAV
    IODC/IODE consistency rule in ephemeris.EphemerisAssembler).
    """

    def __init__(self, prn: int):
        self.eph = Ephemeris(prn=prn, system="galileo")
        self._iods: dict[int, int] = {}
        self.gst: Optional[GstTime] = None

    def feed(self, word: InavWord) -> Optional[Ephemeris]:
        w = word.data
        t = word.word_type

        def u(a, b):
            return _uint(w[a:b])

        def s(a, b):
            return _sint(w[a:b])

        e = self.eph
        if t == 1:
            self._iods[1] = u(6, 16)
            e.t_oe = u(16, 30) * 60.0
            e.m0 = s(30, 62) * 2.0**-31 * PI_ICD
            e.e = u(62, 94) * 2.0**-33
            e.sqrt_a = u(94, 126) * 2.0**-19
        elif t == 2:
            self._iods[2] = u(6, 16)
            e.omega0 = s(16, 48) * 2.0**-31 * PI_ICD
            e.i0 = s(48, 80) * 2.0**-31 * PI_ICD
            e.omega = s(80, 112) * 2.0**-31 * PI_ICD
            e.idot = s(112, 126) * 2.0**-43 * PI_ICD
        elif t == 3:
            self._iods[3] = u(6, 16)
            e.omega_dot = s(16, 40) * 2.0**-43 * PI_ICD
            e.delta_n = s(40, 56) * 2.0**-43 * PI_ICD
            e.c_uc = s(56, 72) * 2.0**-29
            e.c_us = s(72, 88) * 2.0**-29
            e.c_rc = s(88, 104) * 2.0**-5
            e.c_rs = s(104, 120) * 2.0**-5
            e.ura = u(120, 128)
        elif t == 4:
            self._iods[4] = u(6, 16)
            e.c_ic = s(22, 38) * 2.0**-29
            e.c_is = s(38, 54) * 2.0**-29
            e.t_oc = u(54, 68) * 60.0
            e.a_f0 = s(68, 99) * 2.0**-34
            e.a_f1 = s(99, 120) * 2.0**-46
            e.a_f2 = s(120, 126) * 2.0**-59
        elif t == 5:
            e.t_gd = s(47, 57) * 2.0**-32
            e.health = u(69, 71)
            e.week = u(73, 85)
            self.gst = GstTime(
                wn=u(73, 85), tow_s=float(u(85, 105)),
                even_page_index=word.even_page_index,
                even_page_epoch=word.even_page_epoch,
            )
        if (set(self._iods) >= {1, 2, 3, 4}
                and len(set(self._iods.values())) == 1):
            return e
        return None


# ---------------------------------------------------------------------------
# Symbol-stream encoder (simulator source) and streaming decoder
# ---------------------------------------------------------------------------

def encode_symbol_stream(eph: Ephemeris, wn: int, tow0_s: float,
                         n_pages: int = 12, iod_nav: int = 1,
                         order: Optional[list] = None) -> np.ndarray:
    """On-air +/-1 E1B symbol stream of ``n_pages`` nominal pages.

    Cycles word types ``order`` (default [1,2,3,4,5]); each nominal
    page is 2 s (two page parts). Word 5's TOW stamps the start of its
    own even part: tow(page k) = tow0_s + 2k. A receiver cold-starting
    mid-stream always loses the first page — lead with word 5 (``order
    = [5,1,2,3,4]``) to keep the ephemeris words intact.
    """
    if order is None:
        order = [1, 2, 3, 4, 5]
    parts = []
    for k in range(n_pages):
        t = order[k % len(order)]
        word = encode_word(eph, t, iod_nav, wn, tow0_s + 2.0 * k)
        even, odd = build_page(word)
        parts.append(encode_page_part(even))
        parts.append(encode_page_part(odd))
    return np.concatenate(parts).astype(np.int8)


class InavDecoder:
    """Streaming E1B decoder: +/-1 symbols in, words + GST out.

    One symbol per 4 ms code epoch (E1B has no secondary code and one
    symbol per primary-code period). Handles the Costas 180-degree
    polarity ambiguity by matching the sync pattern in both signs and
    verifying the next page part's sync agrees.
    """

    def __init__(self, prn: int):
        self.prn = prn
        self.symbols: list[int] = []
        self.symbol_epochs: list[int] = []
        self._base = 0           # absolute index of symbols[0]
        self.synced = False
        self.polarity = 1
        self.page_start: Optional[int] = None   # ABSOLUTE sync index
        self.assembler = InavAssembler(prn)
        self.words: list[InavWord] = []
        self._pending_even: Optional[tuple[int, np.ndarray]] = None
        self.ephemeris: Optional[Ephemeris] = None
        self.frame_locked = False
        self.word_count = 0
        # absolute symbol index -> tracking epoch, kept for recent pages
        self._epoch_of: dict[int, int] = {}

    @property
    def _n_abs(self) -> int:
        return self._base + len(self.symbols)

    def _trim(self, keep_abs: int) -> None:
        """Drop symbols before absolute index ``keep_abs``."""
        drop = keep_abs - self._base
        if drop > 0:
            del self.symbols[:drop]
            self._base = keep_abs
        for k in [k for k in self._epoch_of if k < keep_abs - PAGE_SYMBOLS]:
            del self._epoch_of[k]

    # -- sync ------------------------------------------------------------
    def _try_sync(self) -> None:
        """Scan every offset in the buffer for two sync patterns one
        page part apart (both polarities); lock on the first hit."""
        n = len(self.symbols)
        need = PAGE_SYMBOLS + 10
        if n < need:
            return
        s = np.asarray(self.symbols, np.int8)
        win = np.lib.stride_tricks.sliding_window_view(s, 10)
        corr = win @ SYNC_PM.astype(np.int32)       # +/-10 at a match
        for pol in (1, -1):
            hit = corr * pol == 10
            cand = np.nonzero(hit[: n - need + 1]
                              & hit[PAGE_SYMBOLS: PAGE_SYMBOLS + n - need + 1]
                              )[0]
            if cand.size:
                self.synced = True
                self.frame_locked = True
                self.polarity = pol
                self.page_start = self._base + int(cand[0])
                return

    def feed_array(self, i_prompts, epochs) -> list[InavWord]:
        """Feed one block of prompt-I values (one per code epoch)."""
        vals = np.sign(np.asarray(i_prompts, np.float64)).astype(np.int8)
        vals[vals == 0] = 1
        for v, e in zip(vals, np.asarray(epochs, np.int64)):
            self._epoch_of[self._n_abs] = int(e)
            self.symbols.append(int(v))
        out = []
        if not self.synced:
            self._try_sync()
            if not self.synced:
                # bound memory while unsynced
                if len(self.symbols) > 4 * PAGE_SYMBOLS:
                    self._trim(self._n_abs - 2 * PAGE_SYMBOLS)
                return out
        # drain complete page parts
        while self._n_abs - self.page_start >= PAGE_SYMBOLS:
            st = self.page_start
            lo = st - self._base
            part = (
                np.asarray(self.symbols[lo:lo + PAGE_SYMBOLS], np.int8)
                * self.polarity
            )
            self.page_start += PAGE_SYMBOLS
            info = decode_page_part(part)
            if info is None:
                # lost sync; restart the search
                self.synced = False
                self._pending_even = None
                self._try_sync()
                if not self.synced:
                    return out
                continue
            if info[0] == 0:
                self._pending_even = (st, info)
                continue
            if self._pending_even is None:
                continue
            even_idx, even = self._pending_even
            self._pending_even = None
            word_bits = parse_page(even, info)
            if word_bits is None:
                continue
            word = InavWord(
                word_type=_uint(word_bits[:6]),
                data=word_bits,
                even_page_index=even_idx,
                even_page_epoch=self._epoch_of.get(even_idx),
            )
            self.word_count += 1
            self.words.append(word)
            eph = self.assembler.feed(word)
            if eph is not None:
                self.ephemeris = eph
            out.append(word)
        # bound symbol memory: keep the last two page parts
        self._trim(max(self._base, self.page_start - PAGE_SYMBOLS))
        return out

    def epoch_of_symbol(self, symbol_index: int) -> Optional[int]:
        """Tracking epoch at which the given ABSOLUTE symbol started."""
        return self._epoch_of.get(symbol_index)
