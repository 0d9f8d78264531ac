"""RINEX v3 GPS navigation-message parser (counterpart of
``gnss_sdr_tpu/nav/rinex.py``, plain Python).

Capability parity with the reference's legacy parser
(reference: src/rinex.rs:228-478: header iono/time-corr/leap, 8-line GPS
records, freshest-ephemeris selection with a 4 h validity window).
Produces the same Ephemeris dataclass the live decoder builds, so PVT is
source-agnostic.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

from .ephemeris import Ephemeris


@dataclasses.dataclass
class RinexNavHeader:
    version: str = ""
    iono_alpha: Optional[tuple] = None   # GPSA
    iono_beta: Optional[tuple] = None    # GPSB
    time_correction: Optional[tuple] = None  # GPUT a0,a1,ref_tow,ref_week
    leap_seconds: Optional[int] = None


@dataclasses.dataclass
class RinexNavRecord:
    prn: int
    toc: datetime.datetime
    eph: Ephemeris


def _f(s: str) -> float:
    s = s.strip().replace("D", "E").replace("d", "e")
    return float(s) if s else 0.0


def _fields(line: str, start: int = 4) -> list[float]:
    """Four 19-char float fields per RINEX line body."""
    out = []
    for k in range(4):
        chunk = line[start + 19 * k:start + 19 * (k + 1)]
        if chunk.strip():
            out.append(_f(chunk))
        else:
            out.append(0.0)
    return out


def parse_nav_file(path: str) -> tuple[RinexNavHeader, list[RinexNavRecord]]:
    with open(path) as f:
        lines = f.read().splitlines()

    header = RinexNavHeader()
    i = 0
    while i < len(lines):
        line = lines[i]
        label = line[60:].strip()
        if label == "RINEX VERSION / TYPE":
            header.version = line[:9].strip()
        elif label == "IONOSPHERIC CORR":
            kind = line[:4].strip()
            vals = tuple(_f(line[5 + 12 * k:5 + 12 * (k + 1)]) for k in range(4))
            if kind == "GPSA":
                header.iono_alpha = vals
            elif kind == "GPSB":
                header.iono_beta = vals
        elif label == "TIME SYSTEM CORR":
            if line[:4].strip() == "GPUT":
                header.time_correction = (
                    _f(line[5:22]), _f(line[22:38]),
                    _f(line[38:45]), _f(line[45:50]),
                )
        elif label == "LEAP SECONDS":
            header.leap_seconds = int(line[:6].strip() or 0)
        i += 1
        if label == "END OF HEADER":
            break

    records: list[RinexNavRecord] = []
    while i < len(lines):
        line = lines[i]
        if not line.startswith("G"):
            i += 1
            continue
        if i + 7 >= len(lines):
            break
        prn = int(line[1:3])
        y, mo, d, h, mi, s = (
            int(line[4:8]), int(line[9:11]), int(line[12:14]),
            int(line[15:17]), int(line[18:20]), int(line[21:23]),
        )
        toc = datetime.datetime(y, mo, d, h, mi, s,
                                tzinfo=datetime.timezone.utc)
        af0, af1, af2 = _f(line[23:42]), _f(line[42:61]), _f(line[61:80])
        rows = [_fields(lines[i + k]) for k in range(1, 8)]
        eph = Ephemeris(
            prn=prn,
            a_f0=af0, a_f1=af1, a_f2=af2,
            iode=int(rows[0][0]), c_rs=rows[0][1],
            delta_n=rows[0][2], m0=rows[0][3],
            c_uc=rows[1][0], e=rows[1][1], c_us=rows[1][2],
            sqrt_a=rows[1][3],
            t_oe=rows[2][0], c_ic=rows[2][1], omega0=rows[2][2],
            c_is=rows[2][3],
            i0=rows[3][0], c_rc=rows[3][1], omega=rows[3][2],
            omega_dot=rows[3][3],
            idot=rows[4][0], week=int(rows[4][2]),
            ura=int(rows[5][0]), health=int(rows[5][1]),
            t_gd=rows[5][2], iodc=int(rows[5][3]),
            t_oc=_gps_seconds_of_week(toc),
        )
        records.append(RinexNavRecord(prn=prn, toc=toc, eph=eph))
        i += 8
    return header, records


_GPS_EPOCH = datetime.datetime(1980, 1, 6, tzinfo=datetime.timezone.utc)


def _gps_seconds_of_week(t: datetime.datetime) -> float:
    delta = (t - _GPS_EPOCH).total_seconds()
    return delta % 604800.0


def select_ephemerides(
    records: list[RinexNavRecord],
    at: datetime.datetime,
    max_age_s: float = 4 * 3600.0,
) -> dict[int, Ephemeris]:
    """Freshest valid ephemeris per PRN (reference semantics:
    rinex.rs:228-322, 4 h validity window)."""
    best: dict[int, RinexNavRecord] = {}
    for rec in records:
        age = abs((at - rec.toc).total_seconds())
        if age > max_age_s:
            continue
        cur = best.get(rec.prn)
        if cur is None or abs((at - cur.toc).total_seconds()) > age:
            best[rec.prn] = rec
    return {prn: rec.eph for prn, rec in best.items()}
