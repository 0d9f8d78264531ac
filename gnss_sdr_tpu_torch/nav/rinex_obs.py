"""RINEX v3 observation-file writer (counterpart of
``gnss_sdr_tpu/nav/rinex_obs.py``; the header names the same program, so
the two packages write the same bytes for the same epochs).

Completes BASELINE.md config ladder 5's "RINEX observables at streaming
rate": per-epoch GPS observables (C1C pseudorange, D1C Doppler, S1C
C/N0) stream into a standard RINEX 3.05 OBS file any geodetic toolchain
can read. The reference has no observable output at all (its legacy
pipeline ends at satellite positions, SURVEY.md §1 L6).
"""
from __future__ import annotations

import datetime
from typing import Optional

_GPS_EPOCH = datetime.datetime(1980, 1, 6, tzinfo=datetime.timezone.utc)


def gps_time_to_datetime(week: int,
                         seconds_of_week: float) -> datetime.datetime:
    """Calendar representation of a GPS-timescale instant (no leap
    correction — RINEX epoch records tagged GPS use this directly)."""
    return _GPS_EPOCH + datetime.timedelta(
        weeks=week, seconds=seconds_of_week
    )


def gps_time_to_utc(week: int, seconds_of_week: float,
                    leap_seconds: int = 18) -> datetime.datetime:
    return gps_time_to_datetime(week, seconds_of_week) - datetime.timedelta(
        seconds=leap_seconds
    )


class RinexObsWriter:
    """Streaming RINEX 3 observation writer (GPS C1C/D1C/S1C)."""

    OBS_TYPES = ("C1C", "D1C", "S1C")

    def __init__(
        self,
        path: str,
        marker_name: str = "GNSSTPU",
        program: str = "gnss_sdr_tpu",
        approx_position: Optional[tuple[float, float, float]] = None,
    ):
        self._f = open(path, "w")
        self._header_done = False
        self._marker = marker_name
        self._program = program
        self._approx = approx_position
        self._first_epoch: Optional[datetime.datetime] = None
        self.epochs_written = 0

    def _line(self, body: str, label: str) -> None:
        self._f.write(f"{body:<60.60s}{label}\n")

    def _write_header(self, first: datetime.datetime) -> None:
        self._line(
            f"{3.05:>9.2f}{'':11s}{'OBSERVATION DATA':<20s}"
            f"{'G: GPS':<20s}",
            "RINEX VERSION / TYPE",
        )
        stamp = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%d %H%M%S UTC"
        )
        self._line(
            f"{self._program:<20.20s}{'':20s}{stamp:<20s}", "PGM / RUN BY / DATE"
        )
        self._line(f"{self._marker:<60s}", "MARKER NAME")
        self._line(f"{'UNKNOWN':<20s}{'UNKNOWN':<40s}", "OBSERVER / AGENCY")
        self._line(
            f"{'0':<20.20s}{'gnss_sdr_tpu':<20.20s}{'0.1':<20.20s}",
            "REC # / TYPE / VERS",
        )
        self._line(f"{'0':<20.20s}{'NONE':<40.40s}", "ANT # / TYPE")
        if self._approx:
            x, y, z = self._approx
            self._line(
                f"{x:14.4f}{y:14.4f}{z:14.4f}", "APPROX POSITION XYZ"
            )
        self._line(f"{0.0:14.4f}{0.0:14.4f}{0.0:14.4f}",
                   "ANTENNA: DELTA H/E/N")
        types = "".join(f" {t:>3s}" for t in self.OBS_TYPES)
        self._line(
            f"G  {len(self.OBS_TYPES):>3d}{types}", "SYS / # / OBS TYPES"
        )
        self._line(
            first.strftime("  %Y    %m    %d    %H    %M   %S.%f0")
            + "     GPS",
            "TIME OF FIRST OBS",
        )
        self._line("", "END OF HEADER")
        self._header_done = True

    def write_epoch(
        self,
        week: int,
        seconds_of_week: float,
        observations: dict[int, tuple[float, float, Optional[float]]],
    ) -> None:
        """One epoch: ``observations`` maps PRN ->
        (pseudorange_m, doppler_hz, cn0_dbhz_or_None)."""
        # epoch records carry GPS time, matching the header's time system
        t = gps_time_to_datetime(week, seconds_of_week)
        if not self._header_done:
            self._first_epoch = t
            self._write_header(t)
        sec = t.second + t.microsecond / 1e6
        self._f.write(
            f"> {t.year:4d} {t.month:02d} {t.day:02d} {t.hour:02d} "
            f"{t.minute:02d}{sec:11.7f}  0{len(observations):3d}\n"
        )
        for prn in sorted(observations):
            pr, dop, cn0 = observations[prn]
            row = f"G{prn:02d}{pr:14.3f}  {dop:14.3f}  "
            row += f"{cn0:14.3f}  " if cn0 is not None else f"{'':16s}"
            self._f.write(row.rstrip() + "\n")
        self.epochs_written += 1

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def parse_obs_file(path: str) -> tuple[dict, list[dict]]:
    """Minimal RINEX 3 OBS reader (round-trip validation + tooling)."""
    header: dict = {"obs_types": []}
    epochs: list[dict] = []
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        label = line[60:].strip()
        if label == "RINEX VERSION / TYPE":
            header["version"] = line[:9].strip()
            header["type"] = line[20:40].strip()
        elif label == "SYS / # / OBS TYPES":
            header["obs_types"] = line[7:60].split()
        elif label == "MARKER NAME":
            header["marker"] = line[:60].strip()
        i += 1
        if label == "END OF HEADER":
            break
    current = None
    while i < len(lines):
        line = lines[i]
        if line.startswith(">"):
            parts = line[1:].split()
            current = {
                "time": datetime.datetime(
                    int(parts[0]), int(parts[1]), int(parts[2]),
                    int(parts[3]), int(parts[4]),
                    tzinfo=datetime.timezone.utc,
                ) + datetime.timedelta(seconds=float(parts[5])),
                "flag": int(parts[6]),
                "sats": {},
            }
            epochs.append(current)
        elif line[:1] == "G" and current is not None:
            prn = int(line[1:3])
            vals = []
            for k in range(len(header["obs_types"])):
                chunk = line[3 + 16 * k:3 + 16 * k + 14]
                vals.append(float(chunk) if chunk.strip() else None)
            current["sats"][prn] = vals
        i += 1
    return header, epochs
