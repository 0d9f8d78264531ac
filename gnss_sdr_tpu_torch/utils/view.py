"""Spectrum analysis and receiver visualization (counterpart of
``gnss_sdr_tpu/utils/view.py``).

Capability parity with the reference's legacy observability surface:
the PSD plot utility (reference src/test_utilities.rs:17-65,
hann-windowed spectrum) and the live NavigationView (src/view.rs:37-116:
satellite visibility bars + prompt I/Q time series). Rendering uses
headless matplotlib into files; all computations are plain NumPy so
they also serve as data APIs without plotting.
"""
from __future__ import annotations

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the headless Agg backend, imported at first
    use: a host without matplotlib runs the receiver, and only a plot
    raises, naming the missing package."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(
            "plotting (--dashboard, --live-png) needs matplotlib, which is "
            "not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def power_spectrum(
    samples: np.ndarray,
    fs_hz: float,
    nfft: int = 4096,
    window: str = "hann",
) -> tuple[np.ndarray, np.ndarray]:
    """Welch-averaged power spectral density in dB.

    Returns (freqs_hz, psd_db). Complex input -> two-sided fftshifted
    spectrum; real input -> one-sided.
    """
    x = np.asarray(samples)
    n_seg = max(1, x.size // nfft)
    x = x[: n_seg * nfft].reshape(n_seg, nfft)
    if window == "hann":
        w = np.hanning(nfft)
    elif window == "hamming":
        w = np.hamming(nfft)
    else:
        w = np.ones(nfft)
    xw = x * w
    if np.iscomplexobj(samples):
        spec = np.fft.fftshift(np.fft.fft(xw, axis=1), axes=1)
        freqs = np.fft.fftshift(np.fft.fftfreq(nfft, 1.0 / fs_hz))
    else:
        spec = np.fft.rfft(xw, axis=1)
        freqs = np.fft.rfftfreq(nfft, 1.0 / fs_hz)
    psd = np.mean(np.abs(spec) ** 2, axis=0) / (fs_hz * np.sum(w**2))
    return freqs, 10.0 * np.log10(np.maximum(psd, 1e-30))


def plot_psd(
    samples: np.ndarray, fs_hz: float, path: str, title: str = "PSD",
    nfft: int = 4096,
) -> None:
    plt = _pyplot()

    freqs, psd_db = power_spectrum(samples, fs_hz, nfft)
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(freqs / 1e6, psd_db, lw=0.7)
    ax.set_xlabel("frequency [MHz]")
    ax.set_ylabel("PSD [dB/Hz]")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_receiver_state(receiver, path: str) -> None:
    """Dashboard: per-channel C/N0 bars, prompt I/Q scatter, Doppler and
    prompt-power histories (the NavigationView surface, view.rs:16-35)."""
    plt = _pyplot()

    traces = receiver.telemetry.all_traces()
    fig, axes = plt.subplots(2, 2, figsize=(12, 8))

    ax = axes[0, 0]
    prns = [t.prn for t in traces]
    cn0s = [t.cn0_dbhz() or 0.0 for t in traces]
    ax.bar([str(p) for p in prns], cn0s)
    ax.set_title("C/N0 by PRN")
    ax.set_ylabel("dB-Hz")

    ax = axes[0, 1]
    for t in traces:
        i_p, q_p = t.prompt()
        ax.scatter(i_p[-200:], q_p[-200:], s=2, label=f"PRN {t.prn}")
    ax.set_title("prompt I/Q")
    ax.axhline(0, color="k", lw=0.3)
    ax.axvline(0, color="k", lw=0.3)
    if traces:
        ax.legend(fontsize=7)

    ax = axes[1, 0]
    for t in traces:
        ax.plot(np.asarray(t.carr_freq) - receiver.f_if, lw=0.8,
                label=f"PRN {t.prn}")
    ax.set_title("Doppler history")
    ax.set_xlabel("epoch")
    ax.set_ylabel("Hz")

    ax = axes[1, 1]
    for t in traces:
        i_p, q_p = t.prompt()
        ax.plot(i_p**2 + q_p**2, lw=0.8, label=f"PRN {t.prn}")
    ax.set_title("prompt power")
    ax.set_xlabel("epoch")
    ax.set_yscale("log")

    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def acquisition_heatmap(
    power: np.ndarray,          # [D, N] one PRN's power cube slice
    doppler_hz: np.ndarray,     # [D]
    fs_hz: float,
    path: str,
    title: str = "PCPS search space",
) -> None:
    """Doppler x code-phase search-space heatmap for one PRN."""
    plt = _pyplot()

    fig, ax = plt.subplots(figsize=(10, 5))
    extent = [0, power.shape[1] / fs_hz * 1e3,
              doppler_hz[0], doppler_hz[-1]]
    ax.imshow(power, aspect="auto", origin="lower", extent=extent,
              cmap="viridis")
    ax.set_xlabel("code phase [ms]")
    ax.set_ylabel("Doppler [Hz]")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
