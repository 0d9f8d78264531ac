"""IGS broadcast-ephemeris (BRDC) retrieval (counterpart of
``gnss_sdr_tpu/nav/download.py``).

Capability parity with the reference's nav-file fetcher
(reference: src/comm_func.rs:31-74 — reqwest + HTML scrape + gzip from
the IGS archive). Uses only the standard library; network failures
raise a clear error so offline deployments fall back to local RINEX
files (this build environment has no egress, so tests exercise the
URL/path construction and the gzip path with local fixtures only).
"""
from __future__ import annotations

import datetime
import gzip
import os
import urllib.error
import urllib.request

DEFAULT_BASE_URL = "https://igs.bkg.bund.de/root_ftp/IGS/BRDC"


def brdc_filename(day: datetime.date) -> str:
    """Standard long-name BRDC product for a given day (GPS nav, daily),
    matching the reference's bundled file naming
    (BRDC00WRD_R_YYYYDDD0000_01D_GN.rnx)."""
    doy = day.timetuple().tm_yday
    return f"BRDC00WRD_R_{day.year}{doy:03d}0000_01D_GN.rnx"


def brdc_url(day: datetime.date, base_url: str = DEFAULT_BASE_URL) -> str:
    doy = day.timetuple().tm_yday
    return f"{base_url}/{day.year}/{doy:03d}/{brdc_filename(day)}.gz"


def fetch_brdc(
    day: datetime.date,
    dest_dir: str = ".",
    base_url: str = DEFAULT_BASE_URL,
    timeout_s: float = 30.0,
) -> str:
    """Download and decompress the daily GPS BRDC file; returns the
    local RINEX path. Raises ConnectionError with guidance offline."""
    dest = os.path.join(dest_dir, brdc_filename(day))
    if os.path.exists(dest):
        return dest
    url = brdc_url(day, base_url)
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            payload = resp.read()
    except (urllib.error.URLError, OSError) as e:
        raise ConnectionError(
            f"could not fetch {url} ({e}); provide a local RINEX nav file "
            "via nav.rinex.parse_nav_file instead"
        ) from e
    data = gzip.decompress(payload) if url.endswith(".gz") else payload
    with open(dest, "wb") as f:
        f.write(data)
    return dest
