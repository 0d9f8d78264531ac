"""Extended Kalman navigation filter over pseudorange/Doppler epochs
(counterpart of ``gnss_sdr_tpu/nav/filter.py``: numpy on the host).

Beyond-reference capability: sequential filtering of the single-point
solutions' raw observables with an 8-state constant-velocity model
x = [pos(3) m, vel(3) m/s, clock bias m, clock drift m/s]. Smooths the
epoch-to-epoch scatter of snapshot least squares and rides through
epochs with fewer than 4 satellites.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import constants as C
from .ephemeris import Ephemeris
from .orbits import satellite_position
from .pvt import _rot_z, solve_pvt


class NavigationFilter:
    def __init__(
        self,
        sigma_accel: float = 0.5,        # m/s^2 process noise (dynamics)
        sigma_clock_drift: float = 0.1,  # m/s^2-equivalent clock wander
        sigma_pr: float = 10.0,          # m pseudorange measurement noise
        sigma_doppler_mps: float = 0.5,  # m/s range-rate noise
    ):
        self.x: Optional[np.ndarray] = None   # [8]
        self.p: Optional[np.ndarray] = None   # [8, 8]
        self.sigma_accel = sigma_accel
        self.sigma_clock_drift = sigma_clock_drift
        self.sigma_pr = sigma_pr
        self.sigma_dop = sigma_doppler_mps
        self.epochs = 0

    @property
    def position(self) -> Optional[np.ndarray]:
        return None if self.x is None else self.x[:3].copy()

    @property
    def velocity(self) -> Optional[np.ndarray]:
        return None if self.x is None else self.x[3:6].copy()

    def _initialize(self, prs, ephs, txs) -> bool:
        sol = solve_pvt(prs, ephs, txs)
        if sol is None:
            return False
        self.x = np.zeros(8)
        self.x[:3] = sol.position_ecef_m
        self.x[6] = sol.clock_bias_m
        self.p = np.diag([100.0**2] * 3 + [10.0**2] * 3
                         + [1000.0**2, 100.0**2])
        return True

    def predict(self, dt: float) -> None:
        if self.x is None:
            return
        f = np.eye(8)
        for k in range(3):
            f[k, 3 + k] = dt
        f[6, 7] = dt
        q = np.zeros((8, 8))
        qa = self.sigma_accel**2
        qc = self.sigma_clock_drift**2
        for k in range(3):
            q[k, k] = qa * dt**4 / 4
            q[k, 3 + k] = q[3 + k, k] = qa * dt**3 / 2
            q[3 + k, 3 + k] = qa * dt**2
        q[6, 6] = qc * dt**4 / 4 + 1.0 * dt   # white clock phase noise
        q[6, 7] = q[7, 6] = qc * dt**3 / 2
        q[7, 7] = qc * dt**2
        self.x = f @ self.x
        self.p = f @ self.p @ f.T + q

    def update(
        self,
        pseudoranges_m: Sequence[float],
        ephemerides: Sequence[Ephemeris],
        transmit_times_s: Sequence[float],
        dopplers_hz: Optional[Sequence[float]] = None,
        carrier_freq_hz: float = 1_575_420_000.0,
    ) -> bool:
        """One measurement epoch; bootstraps from the first solvable
        epoch. Works with any satellite count once initialized."""
        n = len(pseudoranges_m)
        if self.x is None:
            if not self._initialize(
                pseudoranges_m, ephemerides, transmit_times_s
            ):
                return False
        cc = C.SPEED_OF_LIGHT_M_S
        use_dop = dopplers_hz is not None
        m = n * (2 if use_dop else 1)
        z = np.zeros(m)
        h = np.zeros((m, 8))
        pred = np.zeros(m)
        r = np.zeros(m)
        lam = cc / carrier_freq_hz
        for k in range(n):
            pos, vel, clk = satellite_position(
                ephemerides[k], transmit_times_s[k]
            )
            tof = np.linalg.norm(pos - self.x[:3]) / cc
            p_rot = _rot_z(C.OMEGA_E_DOT_RAD_S * tof) @ pos
            d = p_rot - self.x[:3]
            rng = np.linalg.norm(d)
            los = d / rng
            z[k] = pseudoranges_m[k]
            pred[k] = rng + self.x[6] - cc * clk
            h[k, :3] = -los
            h[k, 6] = 1.0
            r[k] = self.sigma_pr**2
            if use_dop:
                j = n + k
                # range rate rr = u.(v_rx - v_sat) with u pointing
                # sat->rx; here los = -u (rx->sat), so
                # rr = los.(v_sat - v_rx)
                z[j] = -dopplers_hz[k] * lam
                pred[j] = np.dot(vel - self.x[3:6], los) + self.x[7]
                h[j, 3:6] = -los
                h[j, 7] = 1.0
                r[j] = self.sigma_dop**2
        innov = z - pred
        s = h @ self.p @ h.T + np.diag(r)
        k_gain = self.p @ h.T @ np.linalg.inv(s)
        self.x = self.x + k_gain @ innov
        ikh = np.eye(8) - k_gain @ h
        self.p = ikh @ self.p @ ikh.T + k_gain @ np.diag(r) @ k_gain.T
        self.epochs += 1
        return True
