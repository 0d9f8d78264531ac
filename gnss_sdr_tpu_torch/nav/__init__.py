from .bits import (  # noqa: F401
    BitSynchronizer,
    FrameDecoder,
    Subframe,
    check_word_parity,
    compute_parity,
    encode_frames,
    encode_subframe,
)
from .ephemeris import Ephemeris, EphemerisAssembler, apply_subframe, encode_words  # noqa: F401
from .orbits import satellite_clock_correction, satellite_position  # noqa: F401
from .pvt import PvtSolution, ecef_to_geodetic, pseudoranges_from_tracking, solve_pvt  # noqa: F401
from .rinex import parse_nav_file, select_ephemerides  # noqa: F401
from .download import brdc_filename, brdc_url, fetch_brdc  # noqa: F401
from .filter import NavigationFilter  # noqa: F401
from .rinex_obs import RinexObsWriter, parse_obs_file  # noqa: F401
from .inav import InavDecoder, InavWord  # noqa: F401
from .bds_d1 import BdsD1Chain  # noqa: F401
from .glonass_nav import GlonassEphemeris, GlonassNavChain  # noqa: F401
