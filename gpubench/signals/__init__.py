"""The signals the generator renders, by the receiver's signal name.

Each gives its spreading code at its rendering unit (a chip, or half a
chip where a BOC subcarrier flips inside it), the unit rate, the units
per code period and per nav symbol, a secondary code over code periods,
the carrier frequency, the code sampled at a rate (the acquisition's
and the tracker's replicas), and a nav-message stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import beidou_b1i, galileo_e1b, glonass_l1of, gps_l1ca


@dataclasses.dataclass(frozen=True)
class Signal:
    """``table(prn)``: +-1 per rendering unit over one code period;
    ``nav(seed, prn, rng)``: an object whose ``bits(first, count)`` gives
    +-1 symbols; ``sample_code(prn, fs)``: one period sampled at fs."""

    table: object
    unit_rate_hz: float
    units_per_code: int
    units_per_symbol: int
    carrier_hz: float
    code_rate_hz: float
    code_length: int
    code_period_ms: int
    sample_code: object
    nav: object
    secondary: np.ndarray | None = None
    boc: bool = False


SIGNALS = {
    "gps_l1ca": Signal(
        table=gps_l1ca.code, unit_rate_hz=gps_l1ca.CODE_RATE_HZ,
        units_per_code=gps_l1ca.CODE_LENGTH,
        units_per_symbol=gps_l1ca.CODE_LENGTH * gps_l1ca.BIT_MS,
        carrier_hz=gps_l1ca.CARRIER_HZ, code_rate_hz=gps_l1ca.CODE_RATE_HZ,
        code_length=gps_l1ca.CODE_LENGTH, code_period_ms=1,
        sample_code=gps_l1ca.sample_code, nav=gps_l1ca.LnavStream),
    "galileo_e1b": Signal(
        table=galileo_e1b.half_chips, unit_rate_hz=2 * galileo_e1b.CODE_RATE_HZ,
        units_per_code=2 * galileo_e1b.CODE_LENGTH,
        units_per_symbol=2 * galileo_e1b.CODE_LENGTH,
        carrier_hz=galileo_e1b.CARRIER_HZ,
        code_rate_hz=galileo_e1b.CODE_RATE_HZ,
        code_length=galileo_e1b.CODE_LENGTH, code_period_ms=4,
        sample_code=galileo_e1b.sample_code, nav=galileo_e1b.InavStream,
        boc=True),
    "beidou_b1i": Signal(
        table=beidou_b1i.code, unit_rate_hz=beidou_b1i.CODE_RATE_HZ,
        units_per_code=beidou_b1i.CODE_LENGTH,
        units_per_symbol=beidou_b1i.CODE_LENGTH * 20,
        carrier_hz=beidou_b1i.CARRIER_HZ,
        code_rate_hz=beidou_b1i.CODE_RATE_HZ,
        code_length=beidou_b1i.CODE_LENGTH, code_period_ms=1,
        sample_code=beidou_b1i.sample_code, nav=beidou_b1i.D1Stream,
        secondary=beidou_b1i.NH),
    "glonass_l1of": Signal(
        table=glonass_l1of.code, unit_rate_hz=glonass_l1of.CODE_RATE_HZ,
        units_per_code=glonass_l1of.CODE_LENGTH,
        units_per_symbol=glonass_l1of.CODE_LENGTH * 10,
        carrier_hz=glonass_l1of.CARRIER_HZ,
        code_rate_hz=glonass_l1of.CODE_RATE_HZ,
        code_length=glonass_l1of.CODE_LENGTH, code_period_ms=1,
        sample_code=glonass_l1of.sample_code,
        nav=glonass_l1of.StringStream),
}
