"""Ready-made receiver configurations for the BASELINE.md config ladder
(counterpart of ``gnss_sdr_tpu/presets.py``, the same configs field for
field). The port runs every ladder: 1, 2 and 5 through ``Receiver``, and
the dicts of ladders 3 and 4 through
``receiver.multi.MultiConstellationReceiver``, on the card or, with
``device="cpu"``, on the CPU.

Each entry returns a ReceiverConfig tuned for that scenario; pass your
sample rate / IF where they depend on the capture.
"""
from __future__ import annotations

from .config import AcqConfig, ReceiverConfig, RfConfig, SdrConfig, TrackConfig


def ladder1_single_sat_capture(fs_hz: float = 16_367_600.0,
                               f_if_hz: float = 4_130_400.0) -> ReceiverConfig:
    """(1) GPS L1 C/A PCPS on a bundled-style int8 IF capture."""
    return ReceiverConfig(
        sdr=SdrConfig(driver="file", sample_rate_hz=fs_hz,
                      file_format="int8_real"),
        rf=RfConfig(freq_if_hz=f_if_hz, output_sample_rate_hz=fs_hz / 4,
                    enable_dc_removal=True, enable_mixing=True, decimation=4),
        acq=AcqConfig(pad_fft=True),
        track=TrackConfig(n_channels=1),
        block_ms=20,
    )


def ladder2_eight_channel(fs_hz: float = 4_092_000.0) -> ReceiverConfig:
    """(2) 8-channel GPS L1 acquisition + tracking, file based."""
    return ReceiverConfig(
        sdr=SdrConfig(driver="file", sample_rate_hz=fs_hz),
        rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs_hz),
        acq=AcqConfig(pad_fft=True),
        track=TrackConfig(n_channels=8, carrier_aiding=True),
        block_ms=100,
    )


def ladder3_galileo(fs_hz: float = 8_184_000.0) -> dict[str, ReceiverConfig]:
    """(3) Galileo E1 BOC(1,1) alongside GPS L1 (MultiConstellationReceiver)."""
    return {
        "gps_l1ca": ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs_hz),
            acq=AcqConfig(signal="gps_l1ca"),
            track=TrackConfig(signal="gps_l1ca", n_channels=8,
                              carrier_aiding=True),
            block_ms=20,
        ),
        "galileo_e1b": ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs_hz),
            acq=AcqConfig(signal="galileo_e1b", n_prn=36,
                          non_coherent_ms=16, detection_threshold=12.0),
            track=TrackConfig(signal="galileo_e1b", n_channels=8,
                              carrier_aiding=True),
            block_ms=20,
        ),
    }


def ladder4_multi_constellation(
    fs_hz: float = 8_184_000.0,
) -> dict[str, ReceiverConfig]:
    """(4) GPS + Galileo + BeiDou B1I + GLONASS FDMA, 32 channels total."""
    return {
        **ladder3_galileo(fs_hz),
        "beidou_b1i": ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs_hz),
            acq=AcqConfig(signal="beidou_b1i", n_prn=37,
                          detection_threshold=10.0),
            track=TrackConfig(signal="beidou_b1i", n_channels=12),
            block_ms=20,
        ),
        "glonass_l1of": ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs_hz),
            acq=AcqConfig(signal="glonass_l1of", n_prn=14,
                          fdma_spacing_hz=562_500.0,
                          fdma_channels=tuple(range(-7, 7))),
            track=TrackConfig(signal="glonass_l1of", n_channels=4),
            block_ms=20,
        ),
    }


def ladder5_full_pipeline(fs_hz: float = 2_046_000.0) -> ReceiverConfig:
    """(5) Full chain to nav decode -> ephemeris -> observables/PVT."""
    return ReceiverConfig(
        rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs_hz),
        acq=AcqConfig(),
        track=TrackConfig(n_channels=12, carrier_aiding=True),
        block_ms=100,
    )
