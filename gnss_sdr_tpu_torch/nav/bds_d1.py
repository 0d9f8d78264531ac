"""BeiDou B1I D1 navigation message: encode + decode (host-side;
counterpart of ``gnss_sdr_tpu/nav/bds_d1.py``, the same code).

Beyond-reference capability: the reference claims BeiDou support
(reference README.md:2) but contains no BeiDou code. This implements
the D1 NAV chain per BDS-SIS-ICD-2.1 for MEO/IGSO satellites:

  1 ms prompts (NH-modulated) -> NH(20) correlation bit sync (resolves
  the 20 ms bit boundary AND the data bit in one step) -> 50 bps bits
  -> preamble 11100010010 frame sync -> BCH(15,11,1) decode (g(x) =
  x^4 + x + 1; words 2-10 carry two bit-interleaved BCH blocks) ->
  300-bit subframes -> SOW + subframes 1-3 -> Keplerian ephemeris.

Bit layout is ICD-EXACT: every word carries 22 information bits
followed by 8 (interleaved) parity bits, and the subframe fields pack
SEQUENTIALLY into the concatenated information stream — which
reproduces the ICD's word-straddling bit numbers exactly (e.g. SF1
t_oc at bits {74..82}+{91..98}, SF2 sqrt_a at {251..262}+{271..290},
SF3 omega0 at {212..232}+{241..251}). Each subframe's field list fills
its 9x22+11 = 209 information bits exactly — a structural consistency
check with ICD tables 5-4..5-10. tests/test_bds_icd_layout.py verifies
the decoder against hand-built bit vectors placed at the ICD's
absolute bit positions (independent of the encoder below).

Timing: SOW (seconds of BDT week) marks the leading edge of the
current subframe's first bit (preamble start), per ICD 5.2.3.
GEO satellites broadcast D2 (different rate/structure) — out of scope;
D1 covers the MEO/IGSO PRNs the synthetic scenes use.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .. import constants as C
from .ephemeris import Ephemeris

NH = np.array([2 * b - 1 for b in C.BDS_NH_CODE], dtype=np.int8)  # +/-1
BIT_MS = 20
PREAMBLE01 = np.array([1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0], dtype=np.uint8)
PREAMBLE_PM = (2 * PREAMBLE01.astype(np.int8) - 1)
SUBFRAME_BITS = 300
WORD_BITS = 30
PI_ICD = 3.1415926535898


# ---------------------------------------------------------------------------
# BCH(15,11,1), g(x) = x^4 + x + 1
# ---------------------------------------------------------------------------

def bch_encode(data11: np.ndarray) -> np.ndarray:
    """11 data bits -> 15-bit systematic codeword (data + 4 parity).

    LFSR division by g(x) = x^4 + x + 1: feedback taps at x^1, x^0."""
    d = np.asarray(data11, np.uint8)
    reg = 0
    for b in d:
        fb = int(b) ^ ((reg >> 3) & 1)
        reg = ((reg << 1) & 0xE)
        if fb:
            reg ^= 0b0011
    par = np.array([(reg >> (3 - i)) & 1 for i in range(4)], np.uint8)
    return np.concatenate([d, par])


_SYND_TO_ERR = None


def _syndrome_table():
    """Syndrome -> error position for single-bit errors."""
    global _SYND_TO_ERR
    if _SYND_TO_ERR is not None:
        return _SYND_TO_ERR
    tab = {}
    base = bch_encode(np.zeros(11, np.uint8))
    for pos in range(15):
        cw = base.copy()
        cw[pos] ^= 1
        s = _syndrome(cw)
        tab[s] = pos
    _SYND_TO_ERR = tab
    return tab


def _syndrome(cw15: np.ndarray) -> int:
    d, p = cw15[:11], cw15[11:]
    exp = bch_encode(d)[11:]
    return int((exp[0] ^ p[0]) << 3 | (exp[1] ^ p[1]) << 2
               | (exp[2] ^ p[2]) << 1 | (exp[3] ^ p[3]))


def bch_decode(cw15: np.ndarray) -> Optional[np.ndarray]:
    """Correct up to one bit error; return 11 data bits or None."""
    cw = np.asarray(cw15, np.uint8).copy()
    s = _syndrome(cw)
    if s == 0:
        return cw[:11]
    pos = _syndrome_table().get(s)
    if pos is None:
        return None
    cw[pos] ^= 1
    if _syndrome(cw) != 0:
        return None
    return cw[:11]


def word_encode(data22: np.ndarray) -> np.ndarray:
    """Words 2-10: two BCH(15,11) blocks, bit-interleaved (ICD 5.1.3)."""
    d = np.asarray(data22, np.uint8)
    a = bch_encode(d[:11])
    b = bch_encode(d[11:])
    out = np.empty(30, np.uint8)
    out[0::2] = a
    out[1::2] = b
    return out


def word_decode(word30: np.ndarray) -> Optional[np.ndarray]:
    a = bch_decode(np.asarray(word30)[0::2])
    b = bch_decode(np.asarray(word30)[1::2])
    if a is None or b is None:
        return None
    return np.concatenate([a, b])


# ---------------------------------------------------------------------------
# Subframe payload layout (209 bits: word1 data 11 + 9 x 22)
# ---------------------------------------------------------------------------

def _bits_of(value: int, n: int) -> np.ndarray:
    return np.array(
        [(int(value) >> (n - 1 - i)) & 1 for i in range(n)], dtype=np.uint8
    )


def _uint(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def _sint(bits) -> int:
    v = _uint(bits)
    if bits[0]:
        v -= 1 << len(bits)
    return v


# (name, nbits, scale, signed) in payload order after FraID+SOW.
# Widths and scales per BDS-SIS-ICD-2.1 tables 5-4..5-10.
_SF1_FIELDS = [
    ("sat_h1", 1, 1, False),
    ("aodc", 5, 1, False),
    ("urai", 4, 1, False),
    ("wn", 13, 1, False),
    ("t_oc", 17, 8.0, False),
    ("t_gd", 10, 1e-10, True),          # TGD1, 0.1 ns
    ("t_gd2", 10, 1e-10, True),         # TGD2 (B2I), 0.1 ns
    # Klobuchar-style ionospheric model (ICD table 5-6); the 8-bit
    # alpha/beta terms sit between TGD2 and the clock polynomial —
    # their presence is what puts a2/a0/a1 at the ICD's exact
    # word-straddling positions ({215,11}, {226,7}+{241,17},
    # {258,5}+{271,17})
    ("alpha0", 8, 2.0**-30, True),
    ("alpha1", 8, 2.0**-27, True),
    ("alpha2", 8, 2.0**-24, True),
    ("alpha3", 8, 2.0**-24, True),
    ("beta0", 8, 2.0**11, True),
    ("beta1", 8, 2.0**14, True),
    ("beta2", 8, 2.0**16, True),
    ("beta3", 8, 2.0**16, True),
    ("a_f2", 11, 2.0**-66, True),
    ("a_f0", 24, 2.0**-33, True),
    ("a_f1", 22, 2.0**-50, True),
    ("aode", 5, 1, False),
]
_SF2_FIELDS = [
    ("delta_n", 16, 2.0**-43 * PI_ICD, True),
    ("c_uc", 18, 2.0**-31, True),
    ("m0", 32, 2.0**-31 * PI_ICD, True),
    ("e", 32, 2.0**-33, False),
    ("c_us", 18, 2.0**-31, True),
    ("c_rc", 18, 2.0**-6, True),
    ("c_rs", 18, 2.0**-6, True),
    ("sqrt_a", 32, 2.0**-19, False),
    ("t_oe_msb", 2, 1, False),
]
_SF3_FIELDS = [
    ("t_oe_lsb", 15, 1, False),
    ("i0", 32, 2.0**-31 * PI_ICD, True),
    ("c_ic", 18, 2.0**-31, True),
    ("omega_dot", 24, 2.0**-43 * PI_ICD, True),
    ("c_is", 18, 2.0**-31, True),
    ("idot", 14, 2.0**-43 * PI_ICD, True),
    ("omega0", 32, 2.0**-31 * PI_ICD, True),
    ("omega", 32, 2.0**-31 * PI_ICD, True),
    ("_rev", 1, 1, False),              # reserved tail bit (bit 292)
]
_FIELDS = {1: _SF1_FIELDS, 2: _SF2_FIELDS, 3: _SF3_FIELDS}
PAYLOAD_BITS = 11 + 9 * 22  # 209


def encode_subframe(fra_id: int, sow: int, fields: dict[str, float]
                    ) -> np.ndarray:
    """One 300-bit on-air D1 subframe (0/1)."""
    payload = np.zeros(PAYLOAD_BITS, np.uint8)
    payload[0:3] = _bits_of(fra_id, 3)
    payload[3:11] = _bits_of(sow >> 12, 8)      # SOW 8 MSBs in word 1
    payload[11:23] = _bits_of(sow & 0xFFF, 12)  # SOW 12 LSBs in word 2
    pos = 23
    for name, nbits, scale, signed in _FIELDS.get(fra_id, []):
        raw = fields.get(name, 0)
        v = int(round(raw / scale)) if scale != 1 else int(raw)
        payload[pos:pos + nbits] = _bits_of(v & ((1 << nbits) - 1), nbits)
        pos += nbits
    # subframes 1-3 fill the information stream EXACTLY (ICD layout)
    assert pos == PAYLOAD_BITS if fra_id in (1, 2, 3) else pos <= PAYLOAD_BITS
    # payload -> words
    out = np.zeros(SUBFRAME_BITS, np.uint8)
    out[0:11] = PREAMBLE01
    # word 1: rev(4) zero, BCH over payload[0:11]
    out[15:30] = bch_encode(payload[0:11])
    for w in range(9):
        out[30 * (w + 1):30 * (w + 2)] = word_encode(
            payload[11 + 22 * w:11 + 22 * (w + 1)]
        )
    return out


def decode_subframe(bits300: np.ndarray) -> Optional[tuple[int, int, dict]]:
    """300 on-air bits -> (fra_id, sow, fields) or None on BCH failure."""
    b = np.asarray(bits300, np.uint8)
    if not np.array_equal(b[:11], PREAMBLE01):
        return None
    w1 = bch_decode(b[15:30])
    if w1 is None:
        return None
    payload = [w1]
    for w in range(9):
        d = word_decode(b[30 * (w + 1):30 * (w + 2)])
        if d is None:
            return None
        payload.append(d)
    p = np.concatenate(payload)
    fra_id = _uint(p[0:3])
    sow = (_uint(p[3:11]) << 12) | _uint(p[11:23])
    pos = 23
    fields = {}
    for name, nbits, scale, signed in _FIELDS.get(fra_id, []):
        seg = p[pos:pos + nbits]
        v = _sint(seg) if signed else _uint(seg)
        fields[name] = v * scale if scale != 1 else v
        pos += nbits
    return fra_id, sow, fields


# ---------------------------------------------------------------------------
# Ephemeris assembly
# ---------------------------------------------------------------------------

class BdsEphemerisAssembler:
    """Merge subframes 1-3 (consistent AODE not modeled: D1 repeats the
    same ephemeris for 30 s minimum; subframe times must be contiguous
    within one frame for the merge to be accepted)."""

    def __init__(self, prn: int):
        self.prn = prn
        self._fields: dict[int, dict] = {}
        self.ephemeris: Optional[Ephemeris] = None

    def feed(self, fra_id: int, fields: dict) -> Optional[Ephemeris]:
        if fra_id in (1, 2, 3):
            self._fields[fra_id] = fields
        if set(self._fields) >= {1, 2, 3}:
            f1, f2, f3 = (self._fields[k] for k in (1, 2, 3))
            e = Ephemeris(prn=self.prn, system="beidou")
            e.week = int(f1["wn"])
            e.health = int(f1["sat_h1"])
            e.ura = int(f1["urai"])
            e.iodc = int(f1["aodc"])
            e.iode = int(f1["aode"])
            e.t_gd = f1["t_gd"]
            e.t_oc = f1["t_oc"]
            e.a_f0, e.a_f1, e.a_f2 = f1["a_f0"], f1["a_f1"], f1["a_f2"]
            e.delta_n = f2["delta_n"]
            e.c_uc, e.c_us = f2["c_uc"], f2["c_us"]
            e.c_rc, e.c_rs = f2["c_rc"], f2["c_rs"]
            e.m0, e.e, e.sqrt_a = f2["m0"], f2["e"], f2["sqrt_a"]
            e.t_oe = (int(round(f2["t_oe_msb"])) << 15
                      | int(round(f3["t_oe_lsb"]))) * 8.0
            e.i0, e.c_ic, e.c_is = f3["i0"], f3["c_ic"], f3["c_is"]
            e.omega_dot, e.idot = f3["omega_dot"], f3["idot"]
            e.omega0, e.omega = f3["omega0"], f3["omega"]
            self.ephemeris = e
            return e
        return None


# ---------------------------------------------------------------------------
# Streaming chain: NH bit sync -> bits -> frames
# ---------------------------------------------------------------------------

class NhBitSynchronizer:
    """20 ms bit sync by NH-code correlation.

    Each 1 ms prompt carries data_bit * nh[k] (* Costas sign). Over one
    aligned bit, sum(prompt * NH) = +/-20 * |amp|; misaligned sums are
    strictly smaller for the NH sequence. Alignment is declared after
    ``confirm`` consecutive full-magnitude correlations at the same
    phase; each aligned correlation then yields the data bit directly
    (NH stripping and integrate-and-dump in one step).
    """

    def __init__(self, confirm: int = 8, min_frac: float = 0.8):
        self.confirm = confirm
        self.min_frac = min_frac
        self.synced = False
        self.boundary_phase: Optional[int] = None
        self._hits = np.zeros(BIT_MS, np.int64)
        self._buf: list[tuple[int, float]] = []   # (epoch, prompt)
        self.bits: list[int] = []
        self.bit_epochs: list[int] = []

    def feed_array(self, i_prompts, epochs) -> list[tuple[int, int]]:
        """Returns completed (bit +/-1, bit_start_epoch) pairs."""
        self._buf.extend(zip(np.asarray(epochs, np.int64),
                             np.asarray(i_prompts, np.float64)))
        out = []
        if not self.synced:
            self._try_sync()
            if not self.synced:
                if len(self._buf) > 40 * BIT_MS:
                    del self._buf[:len(self._buf) - 20 * BIT_MS]
                return out
        # drain aligned 20-epoch groups
        while True:
            # find the first buffered epoch on the boundary phase
            start = None
            for k, (e, _) in enumerate(self._buf):
                if e % BIT_MS == self.boundary_phase:
                    start = k
                    break
            if start is None or len(self._buf) - start < BIT_MS:
                del self._buf[:start if start is not None else len(self._buf)]
                return out
            grp = self._buf[start:start + BIT_MS]
            del self._buf[:start + BIT_MS]
            e0 = grp[0][0]
            vals = np.array([v for _, v in grp])
            eps = np.array([e for e, _ in grp])
            if not np.array_equal(eps, e0 + np.arange(BIT_MS)):
                continue   # gap (dropped epochs): skip this bit
            corr = float(vals @ NH)
            bit = 1 if corr > 0 else -1
            self.bits.append(bit)
            self.bit_epochs.append(int(e0))
            out.append((bit, int(e0)))

    def _try_sync(self) -> None:
        if len(self._buf) < (self.confirm + 1) * BIT_MS:
            return
        eps = np.array([e for e, _ in self._buf], np.int64)
        vals = np.array([v for _, v in self._buf])
        scale = np.median(np.abs(vals)) * BIT_MS
        if scale <= 0:
            return
        for phase in range(BIT_MS):
            idx = np.nonzero(eps % BIT_MS == phase)[0]
            if idx.size == 0:
                continue
            k0 = int(idx[0])
            good = 0
            k = k0
            while k + BIT_MS <= len(self._buf):
                seg_e = eps[k:k + BIT_MS]
                if not np.array_equal(seg_e, seg_e[0] + np.arange(BIT_MS)):
                    break
                c = abs(float(vals[k:k + BIT_MS] @ NH))
                if c >= self.min_frac * scale:
                    good += 1
                    if good >= self.confirm:
                        self.synced = True
                        self.boundary_phase = phase
                        # re-feed from the first confirmed group
                        return
                else:
                    good = 0
                k += BIT_MS
        return


class BdsFrameDecoder:
    """Preamble search + 300-bit D1 subframe assembly."""

    def __init__(self):
        self.bits: list[int] = []
        self.bit_epochs: list[int] = []
        self.frame_locked = False
        self.polarity = 1
        self.frame_start: Optional[int] = None
        self.subframes: list[tuple[int, int, dict, int]] = []

    def feed(self, bit: int, bit_epoch: int) -> Optional[tuple]:
        self.bits.append(int(bit))
        self.bit_epochs.append(int(bit_epoch))
        n = len(self.bits)
        if not self.frame_locked:
            return self._try_lock()
        rel = n - self.frame_start
        if rel >= SUBFRAME_BITS and rel % SUBFRAME_BITS == 0:
            return self._decode_at(n - SUBFRAME_BITS)
        return None

    def _bits01(self, start: int, count: int, pol: int) -> np.ndarray:
        seg = np.asarray(self.bits[start:start + count], np.int8) * pol
        return ((seg + 1) // 2).astype(np.uint8)

    def _try_lock(self) -> Optional[tuple]:
        n = len(self.bits)
        start = n - 11 - SUBFRAME_BITS
        if start < 0:
            return None
        arr = np.asarray(self.bits[start:], np.int8)
        for pol in (1, -1):
            if not np.array_equal(arr[:11] * pol, PREAMBLE_PM):
                continue
            if not np.array_equal(
                arr[SUBFRAME_BITS:SUBFRAME_BITS + 11] * pol, PREAMBLE_PM
            ):
                continue
            dec = decode_subframe(self._bits01(start, SUBFRAME_BITS, pol))
            if dec is None:
                continue
            self.polarity = pol
            self.frame_locked = True
            self.frame_start = start
            out = (*dec, self.bit_epochs[start])
            self.subframes.append(out)
            return out
        return None

    def _decode_at(self, start: int) -> Optional[tuple]:
        dec = decode_subframe(
            self._bits01(start, SUBFRAME_BITS, self.polarity)
        )
        if dec is None:
            return None
        out = (*dec, self.bit_epochs[start])
        self.subframes.append(out)
        return out


class BdsD1Chain:
    """Receiver-facing chain: prompts -> AnchorEvents + ephemeris."""

    signal = "beidou_b1i"

    def __init__(self, prn: int):
        self.prn = prn
        self.bit_sync = NhBitSynchronizer()
        self.frames = BdsFrameDecoder()
        self.assembler = BdsEphemerisAssembler(prn)
        self.count = 0

    @property
    def ephemeris(self) -> Optional[Ephemeris]:
        return self.assembler.ephemeris

    @property
    def synced(self) -> bool:
        """Whether the NH bit sync (NhBitSynchronizer._try_sync) is
        found."""
        return self.bit_sync.synced

    def feed_array(self, i_prompts, epochs) -> list:
        from ..receiver.navproc import AnchorEvent

        events = []
        for bit, e0 in self.bit_sync.feed_array(i_prompts, epochs):
            sf = self.frames.feed(bit, e0)
            if sf is None:
                continue
            fra_id, sow, fields, sf_epoch = sf
            self.count += 1
            self.assembler.feed(fra_id, fields)
            # SOW stamps the leading edge of THIS subframe's first bit
            events.append(AnchorEvent(epoch=sf_epoch, tow_s=float(sow),
                                      payload=sf))
        return events

    def status(self) -> dict:
        return {
            "bit_synced": self.bit_sync.synced,
            "frame_locked": self.frames.frame_locked,
            "subframes": self.count,
        }


# ---------------------------------------------------------------------------
# Simulator source: ephemeris -> 50 bps bit stream (+/-1)
# ---------------------------------------------------------------------------

def ephemeris_fields(eph: Ephemeris) -> dict[int, dict[str, float]]:
    return {
        1: {
            "sat_h1": eph.health, "aodc": eph.iodc, "urai": eph.ura,
            "wn": eph.week, "t_oc": eph.t_oc, "t_gd": eph.t_gd,
            "a_f2": eph.a_f2, "a_f0": eph.a_f0, "a_f1": eph.a_f1,
            "aode": eph.iode,
        },
        2: {
            "delta_n": eph.delta_n, "c_uc": eph.c_uc, "m0": eph.m0,
            "e": eph.e, "c_us": eph.c_us, "c_rc": eph.c_rc,
            "c_rs": eph.c_rs, "sqrt_a": eph.sqrt_a,
            "t_oe_msb": int(round(eph.t_oe / 8.0)) >> 15,
        },
        3: {
            "t_oe_lsb": int(round(eph.t_oe / 8.0)) & 0x7FFF,
            "i0": eph.i0, "c_ic": eph.c_ic, "omega_dot": eph.omega_dot,
            "c_is": eph.c_is, "idot": eph.idot, "omega0": eph.omega0,
            "omega": eph.omega,
        },
    }


def encode_bit_stream(eph: Ephemeris, sow0: int, n_subframes: int = 6,
                      order=None) -> np.ndarray:
    """+/-1 bit stream (50 bps) of consecutive D1 subframes.

    Subframe k starts at SOW = sow0 + 6k (6 s per 300-bit subframe);
    ``order`` overrides the default 1..5 FraID cycle (lead with an
    almanac subframe, e.g. [5,1,2,3], so a cold-starting receiver's
    lost first subframe is expendable)."""
    f = ephemeris_fields(eph)
    parts = []
    for k in range(n_subframes):
        fra = order[k % len(order)] if order else k % 5 + 1
        parts.append(encode_subframe(fra, sow0 + 6 * k, f.get(fra, {})))
    bits01 = np.concatenate(parts)
    return (2 * bits01.astype(np.int8) - 1)
