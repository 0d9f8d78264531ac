"""GPS LNAV subframes 1-3 to ephemeris fields (IS-GPS-200 20.3.3,
scale factors as powers of two, angles in semicircles times the ICD's
pi): the benchmark's own decoder of the words it broadcast, which the
receiver's decoded subframes and ephemerides are held to."""
from __future__ import annotations

import numpy as np

PI = 3.1415926535898


def _bits(words: np.ndarray, parts) -> list[int]:
    """Bits of (word 3..10, first bit 1..24, count) pieces of words
    3..10 ([8, 24]), MSB piece first."""
    out = []
    for w, b, n in parts:
        out.extend(int(v) for v in words[w - 3, b - 1:b - 1 + n])
    return out


def _u(words, parts) -> int:
    v = 0
    for b in _bits(words, parts):
        v = (v << 1) | b
    return v


def _s(words, parts) -> int:
    bits = _bits(words, parts)
    v = _u(words, parts)
    return v - (1 << len(bits)) if bits[0] else v


def ephemeris(eph_words: dict[int, np.ndarray]) -> dict[str, float]:
    """Field values of the ephemeris in subframes 1, 2 and 3."""
    d1, d2, d3 = eph_words[1], eph_words[2], eph_words[3]
    return dict(
        week=_u(d1, [(3, 1, 10)]), ura=_u(d1, [(3, 13, 4)]),
        health=_u(d1, [(3, 17, 6)]),
        iodc=_u(d1, [(3, 23, 2), (8, 1, 8)]),
        t_gd=_s(d1, [(7, 17, 8)]) * 2.0 ** -31,
        t_oc=_u(d1, [(8, 9, 16)]) * 16.0,
        a_f2=_s(d1, [(9, 1, 8)]) * 2.0 ** -55,
        a_f1=_s(d1, [(9, 9, 16)]) * 2.0 ** -43,
        a_f0=_s(d1, [(10, 1, 22)]) * 2.0 ** -31,
        iode=_u(d2, [(3, 1, 8)]),
        c_rs=_s(d2, [(3, 9, 16)]) * 2.0 ** -5,
        delta_n=_s(d2, [(4, 1, 16)]) * 2.0 ** -43 * PI,
        m0=_s(d2, [(4, 17, 8), (5, 1, 24)]) * 2.0 ** -31 * PI,
        c_uc=_s(d2, [(6, 1, 16)]) * 2.0 ** -29,
        e=_u(d2, [(6, 17, 8), (7, 1, 24)]) * 2.0 ** -33,
        c_us=_s(d2, [(8, 1, 16)]) * 2.0 ** -29,
        sqrt_a=_u(d2, [(8, 17, 8), (9, 1, 24)]) * 2.0 ** -19,
        t_oe=_u(d2, [(10, 1, 16)]) * 16.0,
        c_ic=_s(d3, [(3, 1, 16)]) * 2.0 ** -29,
        omega0=_s(d3, [(3, 17, 8), (4, 1, 24)]) * 2.0 ** -31 * PI,
        c_is=_s(d3, [(5, 1, 16)]) * 2.0 ** -29,
        i0=_s(d3, [(5, 17, 8), (6, 1, 24)]) * 2.0 ** -31 * PI,
        c_rc=_s(d3, [(7, 1, 16)]) * 2.0 ** -5,
        omega=_s(d3, [(7, 17, 8), (8, 1, 24)]) * 2.0 ** -31 * PI,
        omega_dot=_s(d3, [(9, 1, 24)]) * 2.0 ** -43 * PI,
        idot=_s(d3, [(10, 9, 14)]) * 2.0 ** -43 * PI,
    )


def wrong_subframes(decoded, stream) -> tuple[int, int]:
    """(checked, wrong) over the receiver's decoded subframes of one
    satellite (objects with ``subframe_id``, ``tow_counts`` and ``data``
    [10, 24]) against the broadcast ``stream`` (signals.gps_l1ca
    LnavStream)."""
    wrong = 0
    for sf in decoded:
        s = int(sf.tow_counts) - stream.tow0 - 1
        if s < 0:
            wrong += 1
            continue
        sf_id, _, words = stream.subframe(s)
        got = np.asarray(sf.data)[2:]
        # word 10's last two data bits are the t-bits the encoder solves
        # for its parity, not message bits
        if (int(sf.subframe_id) != sf_id
                or not np.array_equal(got[:7], words[:7])
                or not np.array_equal(got[7, :22], words[7, :22])):
            wrong += 1
    return len(decoded), wrong


def wrong_ephemeris(eph, stream) -> int:
    """Fields of the receiver's decoded ephemeris ``eph`` that differ
    from the broadcast one."""
    want = ephemeris(stream.eph_words)
    return sum(float(getattr(eph, k)) != float(v) for k, v in want.items())
