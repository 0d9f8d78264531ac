"""GLONASS L1OF navigation message: encode + decode (host-side;
counterpart of ``gnss_sdr_tpu/nav/glonass_nav.py``, the same code).

Beyond-reference capability: the reference claims GLONASS support
(reference README.md:2) but contains no GLONASS code. This implements
the L1OF nav chain per the GLONASS ICD (edition 5.1):

  1 ms prompts -> 10 ms half-symbols (100 Hz) -> time-mark correlation
  (30-symbol fixed sequence, resolves string boundary + Costas
  polarity) -> bi-binary (meander) demodulation of the 1.7 s data part
  -> differential (relative-code) decode -> 85-bit string -> Hamming
  (85,77) single-error correction -> strings 1-4 -> PZ-90 state-vector
  ephemeris (position/velocity/acceleration at t_b) + time (tk, NT).

String layouts are ICD-EXACT (tables 4.5/4.9): field order, widths,
scale factors, reserved-bit positions, and the sign-magnitude number
convention; every string's field list fills bits 84..9 exactly. The
Hamming (85,77) KX code reproduces the ICD's published check-bit
index sets: check c_j covers the data bits whose systematic-Hamming
position (the j-th non-power-of-two integer >= 3 for ICD bit 8+j) has
bit j-1 set — which yields exactly the ICD 4.7 sets, e.g.
C5 = {20..34, 50..65, 81..85}, C6 = {35..65}, C7 = {66..85}.
c1..c7 occupy string bits 1..7 and the overall parity c_sigma bit 8,
per ICD 4.7. tests/test_glonass_icd_layout.py validates the decoder
against hand-built strings using independently transcribed index-set
tables.

Timing: the anchor is the START of a string's data part; string m of a
frame starts at day time tk_s + 2*(m-1) (tk = frame start, Moscow
decree time scale; day number NT). The chain reports tow_s as seconds
within the GLONASS day — single-system PVT is unaffected and
multi-system PVT solves a per-system clock anyway (nav/pvt.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# 30-symbol time mark (ICD 4.3), transmitted MSB first, no meander
TIME_MARK = np.array(
    [1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 0, 1, 0, 0,
     0, 0, 1, 0, 0, 1, 0, 1, 1, 0], dtype=np.uint8
)
TM_PM = (2 * TIME_MARK.astype(np.int8) - 1)
STRING_BITS = 85
DATA_BITS = 76            # bits 84..9 (bit 85 is the idle '0')
CHECK_BITS = 8            # bits 8..1
HALF_MS = 10              # 10 ms per bi-binary half-symbol
STRING_HALVES = 200       # 2 s: 170 data halves + 30 time-mark symbols
DATA_HALVES = 170


# ---------------------------------------------------------------------------
# Hamming (85,77): 7 syndrome bits + overall parity
# ---------------------------------------------------------------------------

def _syndrome_codes() -> np.ndarray:
    """A unique >= 2-bit 7-bit code per data position 9..85 (77 codes).

    Single-weight codes are reserved for the check bits themselves so
    one flipped check bit yields a weight-1 syndrome (standard
    systematic Hamming geometry, as in the ICD's KX code)."""
    codes = []
    v = 3
    while len(codes) < 77:
        if bin(v).count("1") >= 2:
            codes.append(v)
        v += 1
    return np.array(codes, dtype=np.int64)


_CODES = _syndrome_codes()         # index 0 <-> bit 9, ... index 76 <-> 85


def hamming_encode(data77: np.ndarray) -> np.ndarray:
    """77 data bits (bit85 first) -> 85-bit string (checks in bits 8..1).

    Returned array is in TRANSMIT order: index 0 = bit 85 (idle),
    index 84 = bit 1 (last check bit)."""
    d = np.asarray(data77, np.uint8)
    assert d.size == 77
    checks = np.zeros(7, np.uint8)
    for k in range(7):
        mask = (_CODES >> k) & 1
        # data index i corresponds to ICD bit 9+i; transmit order is
        # reversed (bit 85 first): d[0] is bit 85 <-> code index 76
        checks[k] = int(np.bitwise_xor.reduce(d[::-1] & mask.astype(np.uint8)))
    out = np.concatenate([d, np.zeros(8, np.uint8)])
    # ICD 4.7 placement: c_k in string bit k (transmit index 85 - k),
    # overall parity c_sigma in bit 8 (transmit index 77)
    for k in range(7):
        out[84 - k] = checks[k]
    out[77] = int(np.bitwise_xor.reduce(out[:77])) ^ int(
        np.bitwise_xor.reduce(out[78:]))
    return out


def hamming_decode(string85: np.ndarray) -> Optional[np.ndarray]:
    """Correct up to one bit error; return 77 data bits or None."""
    s = np.asarray(string85, np.uint8).copy()
    d = s[:77]
    syn = 0
    for k in range(7):
        mask = ((_CODES >> k) & 1).astype(np.uint8)
        c = int(np.bitwise_xor.reduce(d[::-1] & mask)) ^ int(s[84 - k])
        syn |= c << k
    par = int(np.bitwise_xor.reduce(s))   # total parity (c_sigma even)
    if syn == 0 and par == 0:
        return d
    if syn == 0 and par == 1:
        return d                      # overall-parity bit itself flipped
    if par == 0:
        return None                   # even error count >= 2
    # single error: find the flipped bit
    if bin(syn).count("1") == 1:
        k = syn.bit_length() - 1
        s[84 - k] ^= 1
        return s[:77]
    idx = np.nonzero(_CODES == syn)[0]
    if idx.size == 0:
        return None
    s[76 - int(idx[0])] ^= 1
    return s[:77]


# ---------------------------------------------------------------------------
# String field layouts (ICD tables 4.5/4.9; sign-magnitude)
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


def _sm_encode(x: float, scale: float, n: int) -> np.ndarray:
    """Sign-magnitude field: MSB = sign, remaining = |value|/scale."""
    mag = int(round(abs(x) / scale))
    mag = min(mag, (1 << (n - 1)) - 1)
    v = mag | ((1 << (n - 1)) if x < 0 else 0)
    return _bits_of(v, n)


def _sm_decode(bits, scale: float) -> float:
    v = _uint(bits[1:])
    return -v * scale if bits[0] else v * scale


# (name, nbits, scale, kind) kind: u=unsigned, s=sign-magnitude
# Exact ICD table 4.5 layouts including reserved bits — each list
# fills bits 80..9 exactly (72 bits after the 4-bit string number m at
# bits 84..81), reproducing the ICD's absolute field positions (e.g.
# string 1 tk at bits 76..65, x_dot at 64..41, x at 35..9).
_STRING_FIELDS = {
    1: [("_rsvd", 2, 1, "u"), ("p1", 2, 1, "u"),
        ("tk_h", 5, 1, "u"), ("tk_m", 6, 1, "u"), ("tk_30", 1, 1, "u"),
        ("vx", 24, 2.0**-20, "s"), ("ax", 5, 2.0**-30, "s"),
        ("x", 27, 2.0**-11, "s")],
    2: [("bn", 3, 1, "u"), ("p2", 1, 1, "u"), ("tb", 7, 15 * 60.0, "u"),
        ("_rsvd", 5, 1, "u"),
        ("vy", 24, 2.0**-20, "s"), ("ay", 5, 2.0**-30, "s"),
        ("y", 27, 2.0**-11, "s")],
    3: [("p3", 1, 1, "u"), ("gamma_n", 11, 2.0**-40, "s"),
        ("_rsvd", 1, 1, "u"), ("p", 2, 1, "u"), ("ln", 1, 1, "u"),
        ("vz", 24, 2.0**-20, "s"), ("az", 5, 2.0**-30, "s"),
        ("z", 27, 2.0**-11, "s")],
    4: [("tau_n", 22, 2.0**-30, "s"), ("dtau_n", 5, 2.0**-30, "s"),
        ("en", 5, 1, "u"), ("_rsvd", 14, 1, "u"), ("p4", 1, 1, "u"),
        ("ft", 4, 1, "u"), ("_rsvd2", 3, 1, "u"),
        ("nt", 11, 1, "u"), ("n", 5, 1, "u"), ("m_type", 2, 1, "u")],
}


def encode_string(m: int, fields: dict[str, float]) -> np.ndarray:
    """85-bit string (transmit order, 0/1): idle + m + fields + checks."""
    data = np.zeros(77, np.uint8)
    data[0] = 0                       # idle bit (bit 85) always 0
    data[1:5] = _bits_of(m, 4)
    pos = 5
    for name, nbits, scale, kind in _STRING_FIELDS.get(m, []):
        val = fields.get(name, 0)
        if kind == "s":
            data[pos:pos + nbits] = _sm_encode(float(val), scale, nbits)
        else:
            data[pos:pos + nbits] = _bits_of(
                int(round(float(val) / scale)) if scale != 1 else int(val),
                nbits)
        pos += nbits
    # strings 1-4 fill bits 84..9 exactly (ICD table 4.5)
    assert pos == 77 if m in (1, 2, 3, 4) else pos <= 77
    return hamming_encode(data)


def decode_string(string85: np.ndarray) -> Optional[tuple[int, dict]]:
    data = hamming_decode(string85)
    if data is None or data[0] != 0:
        return None
    m = _uint(data[1:5])
    pos = 5
    fields = {}
    for name, nbits, scale, kind in _STRING_FIELDS.get(m, []):
        seg = data[pos:pos + nbits]
        fields[name] = (_sm_decode(seg, scale) if kind == "s"
                        else _uint(seg) * (scale if scale != 1 else 1))
        pos += nbits
    return m, fields


# ---------------------------------------------------------------------------
# Line coding: relative code + bi-binary meander + time mark
# ---------------------------------------------------------------------------

def encode_line(string85: np.ndarray) -> np.ndarray:
    """85 bits -> 200 half-symbol levels (+/-1): differential encode,
    meander (each bit -> +b, -b), then the 30-symbol time mark."""
    rel = np.zeros(85, np.uint8)
    prev = 0
    for i, b in enumerate(np.asarray(string85, np.uint8)):
        prev = prev ^ int(b)
        rel[i] = prev
    lv = 1 - 2 * rel.astype(np.int8)                 # 0 -> +1
    halves = np.empty(DATA_HALVES, np.int8)
    halves[0::2] = lv
    halves[1::2] = -lv
    return np.concatenate([halves, TM_PM])


def decode_line(halves200: np.ndarray) -> Optional[np.ndarray]:
    """200 half-symbols -> 85 bits (assumes time-mark-verified input)."""
    h = np.asarray(halves200)
    lv = np.sign(h[0:DATA_HALVES:2] - h[1:DATA_HALVES:2])
    if np.any(lv == 0):
        return None
    rel = ((1 - lv) // 2).astype(np.uint8)
    bits = np.empty(85, np.uint8)
    bits[0] = rel[0]                   # differential seed is 0
    bits[1:] = rel[1:] ^ rel[:-1]
    return bits


# ---------------------------------------------------------------------------
# Ephemeris (PZ-90 state vector)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GlonassEphemeris:
    """PZ-90 broadcast state at t_b (converted to SI: m, m/s, m/s^2)."""

    prn: int = 0                      # frequency-channel slot
    system: str = "glonass"
    pos_m: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    vel_m_s: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    acc_m_s2: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    t_b_s: float = 0.0                # day time of the state epoch
    gamma_n: float = 0.0              # relative freq offset
    tau_n: float = 0.0                # clock bias (s)
    nt: int = 0                       # calendar day number
    health: int = 0

    def clock_correction(self, t_day_s: float) -> float:
        """SV clock offset at day time t (ICD: -tau_n + gamma_n*dt)."""
        return -self.tau_n + self.gamma_n * (t_day_s - self.t_b_s)


class GlonassAssembler:
    """Strings 1-4 (same frame) -> GlonassEphemeris + frame time."""

    def __init__(self, prn: int):
        self.prn = prn
        self._f: dict[int, dict] = {}
        self.ephemeris: Optional[GlonassEphemeris] = None
        self.tk_s: Optional[float] = None

    def feed(self, m: int, fields: dict) -> Optional[GlonassEphemeris]:
        if m in (1, 2, 3, 4):
            self._f[m] = fields
        if m == 1:
            self.tk_s = (fields["tk_h"] * 3600.0 + fields["tk_m"] * 60.0
                         + fields["tk_30"] * 30.0)
        if set(self._f) >= {1, 2, 3, 4}:
            f1, f2, f3, f4 = (self._f[k] for k in (1, 2, 3, 4))
            km = 1e3
            e = GlonassEphemeris(
                prn=self.prn,
                pos_m=np.array([f1["x"], f2["y"], f3["z"]]) * km,
                vel_m_s=np.array([f1["vx"], f2["vy"], f3["vz"]]) * km,
                acc_m_s2=np.array([f1["ax"], f2["ay"], f3["az"]]) * km,
                t_b_s=f2["tb"],
                gamma_n=f3["gamma_n"],
                tau_n=f4["tau_n"],
                nt=int(f4["nt"]),
                health=int(f2["bn"]),
            )
            self.ephemeris = e
            return e
        return None


# ---------------------------------------------------------------------------
# Streaming chain
# ---------------------------------------------------------------------------

class GlonassNavChain:
    """Receiver-facing chain: 1 ms prompts -> strings -> ephemeris.

    Half-symbol clock: 10 consecutive 1 ms epochs integrate into one
    100 Hz half-symbol. The time mark pins both the string boundary and
    the Costas polarity; each verified string yields an AnchorEvent at
    its data-part start with tow_s = tk + 2*(m-1) (day seconds).
    """

    signal = "glonass_l1of"

    def __init__(self, prn: int):
        self.prn = prn
        self.assembler = GlonassAssembler(prn)
        self._halves: list[float] = []          # accumulated half-symbols
        self._half_epochs: list[int] = []       # start epoch per half
        self._pbuf: list[tuple[int, float]] = []  # prompts while unsynced
        self._half_phase: Optional[int] = None  # epoch % 10 of half starts
        self._acc = 0.0
        self._acc_n = 0
        self._acc_epoch0: Optional[int] = None
        self._next_epoch: Optional[int] = None
        self.synced = False
        self.polarity = 1
        self._string_start: Optional[int] = None  # index into _halves
        self.count = 0
        self.strings: list[tuple[int, dict]] = []

    @property
    def ephemeris(self) -> Optional[GlonassEphemeris]:
        return self.assembler.ephemeris

    @property
    def frame_locked(self) -> bool:
        return self.synced

    # -- half-symbol integrate-and-dump --------------------------------
    def _accumulate(self, i_prompts, epochs) -> None:
        """Integrate 10 consecutive epochs into half-symbols, aligned to
        the discovered ``_half_phase`` (epoch % 10 of half starts)."""
        for v, e in zip(np.asarray(i_prompts, np.float64),
                        np.asarray(epochs, np.int64)):
            e = int(e)
            if self._next_epoch is not None and e != self._next_epoch:
                # dropped epochs: restart the current half-symbol
                self._acc = 0.0
                self._acc_n = 0
                self._acc_epoch0 = None
            self._next_epoch = e + 1
            if self._acc_n == 0:
                if e % HALF_MS != self._half_phase:
                    continue
                self._acc_epoch0 = e
            self._acc += float(v)
            self._acc_n += 1
            if self._acc_n == HALF_MS:
                self._halves.append(self._acc)
                self._half_epochs.append(self._acc_epoch0)
                self._acc = 0.0
                self._acc_n = 0
                self._acc_epoch0 = None

    @staticmethod
    def _mark_search(h_sign: np.ndarray) -> Optional[tuple[int, int]]:
        """Find two time marks one string apart: (index, polarity)."""
        if h_sign.size < STRING_HALVES + 30:
            return None
        win = np.lib.stride_tricks.sliding_window_view(h_sign, 30)
        corr = win @ TM_PM.astype(np.int32)
        for pol in (1, -1):
            hit = corr * pol == 30
            lim = hit.size - STRING_HALVES
            if lim <= 0:
                continue
            cand = np.nonzero(hit[:lim] & hit[STRING_HALVES:])[0]
            if cand.size:
                return int(cand[0]), pol
        return None

    def _try_sync(self) -> None:
        """Joint search over the half-symbol phase (epoch % 10) and the
        string boundary (time-mark correlation at each phase)."""
        if len(self._pbuf) < (2 * STRING_HALVES + 31) * HALF_MS:
            return
        eps = np.array([e for e, _ in self._pbuf], np.int64)
        vals = np.array([v for _, v in self._pbuf])
        # joint phase + boundary search. A misaligned phase can still
        # pass the sign-level mark correlation (each mixed sum follows
        # its majority symbol), so among phases whose mark search hits,
        # keep the one with MAXIMUM mean |half| — symbol mixing strictly
        # reduces it, so the true phase wins (a 9-epoch phase error
        # would put a 9 ms bias on every anchor).
        best = None
        for phase in range(HALF_MS):
            k0 = int(np.argmax(eps % HALF_MS == phase))
            if eps[k0] % HALF_MS != phase:
                continue
            n_h = (eps.size - k0) // HALF_MS
            if n_h < STRING_HALVES + 30:
                continue
            seg = vals[k0:k0 + n_h * HALF_MS].reshape(n_h, HALF_MS)
            halves = seg.sum(axis=1)
            found = self._mark_search(np.sign(halves).astype(np.int8))
            if found is None:
                continue
            metric = float(np.mean(np.abs(halves)))
            if best is None or metric > best[0]:
                best = (metric, phase, k0, n_h, halves, found)
        if best is not None:
            _, phase, k0, n_h, halves, (c, pol) = best
            self.synced = True
            self.polarity = pol
            self._half_phase = phase
            self._halves = list(halves)
            self._half_epochs = list(eps[k0:k0 + n_h * HALF_MS:HALF_MS])
            # resume epoch-level accumulation after the converted run
            tail = k0 + n_h * HALF_MS
            self._acc = float(vals[tail:].sum())
            self._acc_n = int(eps.size - tail)
            self._acc_epoch0 = int(eps[tail]) if self._acc_n else None
            self._pbuf = []
            # string data starts right after the found mark; if the
            # buffer also holds the string the mark TERMINATES, back up
            # one string so it decodes too
            if c >= DATA_HALVES:
                self._string_start = c + 30 - STRING_HALVES
            else:
                self._string_start = c + 30
            return

    def _lose_sync(self) -> None:
        self.synced = False
        self._half_phase = None
        self._halves = []
        self._half_epochs = []
        self._pbuf = []
        self._acc = 0.0
        self._acc_n = 0
        self._acc_epoch0 = None
        self._string_start = None

    def feed_array(self, i_prompts, epochs) -> list:
        from ..receiver.navproc import AnchorEvent

        events = []
        if not self.synced:
            eps = np.asarray(epochs, np.int64)
            if (self._pbuf and eps.size
                    and int(eps[0]) != self._pbuf[-1][0] + 1):
                self._pbuf = []        # epoch gap: restart the buffer
            self._pbuf.extend(
                zip((int(e) for e in eps),
                    np.asarray(i_prompts, np.float64)))
            self._try_sync()
            if not self.synced:
                cap = (4 * STRING_HALVES + 31) * HALF_MS
                if len(self._pbuf) > cap:
                    del self._pbuf[:len(self._pbuf) - cap]
                return events
        else:
            self._accumulate(i_prompts, epochs)
        while len(self._halves) - self._string_start >= STRING_HALVES:
            st = self._string_start
            seg = (np.asarray(self._halves[st:st + STRING_HALVES])
                   * self.polarity)
            self._string_start += STRING_HALVES
            if not np.array_equal(
                np.sign(seg[DATA_HALVES:]).astype(np.int8), TM_PM
            ):
                self._lose_sync()
                return events
            bits = decode_line(seg)
            if bits is None:
                continue
            dec = decode_string(bits)
            if dec is None:
                continue
            m, fields = dec
            self.count += 1
            self.strings.append(dec)
            self.assembler.feed(m, fields)
            tk = self.assembler.tk_s
            if tk is not None and 1 <= m <= 15:
                events.append(AnchorEvent(
                    epoch=self._half_epochs[st],
                    tow_s=tk + 2.0 * (m - 1),
                    payload=dec,
                ))
        # bound memory
        keep = self._string_start - STRING_HALVES
        if keep > STRING_HALVES:
            del self._halves[:keep]
            del self._half_epochs[:keep]
            self._string_start -= keep
        return events

    def status(self) -> dict:
        return {
            "bit_synced": self.synced,
            "frame_locked": self.synced,
            "subframes": self.count,
        }


# ---------------------------------------------------------------------------
# Simulator source
# ---------------------------------------------------------------------------

def ephemeris_fields(geph: GlonassEphemeris, tk_s: float
                     ) -> dict[int, dict[str, float]]:
    km = 1e-3
    return {
        1: {"tk_h": int(tk_s // 3600), "tk_m": int(tk_s % 3600 // 60),
            "tk_30": int(tk_s % 60 // 30),
            "x": geph.pos_m[0] * km, "vx": geph.vel_m_s[0] * km,
            "ax": geph.acc_m_s2[0] * km},
        2: {"bn": geph.health, "tb": geph.t_b_s,
            "y": geph.pos_m[1] * km, "vy": geph.vel_m_s[1] * km,
            "ay": geph.acc_m_s2[1] * km},
        3: {"gamma_n": geph.gamma_n,
            "z": geph.pos_m[2] * km, "vz": geph.vel_m_s[2] * km,
            "az": geph.acc_m_s2[2] * km},
        4: {"tau_n": geph.tau_n, "nt": geph.nt, "n": geph.prn},
    }


def encode_bit_stream(geph: GlonassEphemeris, tk_s: float,
                      n_strings: int = 8, order=None) -> np.ndarray:
    """+/-1 half-symbol stream (100 Hz) of consecutive strings.

    models/signal.py modulates this at symbols_per_bit=10 (one level
    per 10 code epochs). ``order`` overrides the default 1..15 string
    cycle — lead with an almanac string (e.g. [15,1,2,3,4]) so the
    string a cold-starting receiver loses is expendable; ``tk_s`` must
    then be the day time at which string 1 starts."""
    f = ephemeris_fields(geph, tk_s)
    parts = []
    for k in range(n_strings):
        m = order[k % len(order)] if order else k % 15 + 1
        parts.append(encode_line(encode_string(m, f.get(m, {}))))
    return np.concatenate(parts).astype(np.int8)
