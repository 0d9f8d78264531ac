"""Plain reference of the scanned tracker (DLL/PLL over one resident
block of samples, one epoch at a time), the benchmark's frozen copy of
its plain PyTorch version.

Per epoch and channel: the epoch's sample count from the code rate, the
carrier wiped off by an exact uint32 NCO, the E/P/L sums against the
code gathered at the prompt chip phase (early and late the prompt moved
by ``el_shift`` samples), the Costas PLL and the early-late envelope
DLL through second-order loop filters on locked epochs, the
power lock detector, and the exact ledger (u32 carrier phase, integer
chip and u32 fractional chip) advanced over the epoch.

``dtype`` is the float precision of every float quantity: float32 is
the configuration's, bfloat16 the control's. ``Tracker`` is the
module's face as a configuration's tracking reference
(``reference/__init__.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

U32 = 4294967296.0
MASK32 = 0xFFFFFFFF
TWO_PI = 6.283185307179586
FIELDS = ("active", "prn_idx", "offset", "epochs", "lost_count",
          "carr_freq", "carr_acc", "carr_err", "code_rate", "chip_int",
          "chip_frac_u32", "code_err", "lock_ema")
TELEM = ("processed", "i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "power",
         "locked", "lost_event", "pll_err", "dll_err", "carr_freq",
         "code_rate", "start_offset", "epoch_index", "chip_phase")


@dataclasses.dataclass(frozen=True)
class Params:
    fs_hz: float
    code_length: int
    window: int
    n0: int
    el_shift: int
    lock_threshold: float
    max_lost_epochs: int
    pll_tau1: float
    pll_tau2: float
    dll_tau1: float
    dll_tau2: float
    dt: float


def _taus(bw, damping, gain):
    w = bw * 8.0 * damping / (4.0 * damping * damping + 1.0)
    return gain / (w * w), 2.0 * damping / w


def params(track: dict, fs_hz: float, code_length: int,
           code_rate_hz: float, code_period_ms: int) -> Params:
    """The tracker's constants from the configuration's ``track``
    section (a BPSK signal, no carrier aiding, no code interpolation)."""
    p1, p2 = _taus(track["pll_bandwidth_hz"], track["pll_damping"],
                   track["pll_gain"])
    d1, d2 = _taus(track["dll_bandwidth_hz"], track["dll_damping"],
                   track["dll_gain"])
    n0 = int(round(fs_hz * code_period_ms / 1000.0))
    el = track["early_late_chips"]
    return Params(
        fs_hz=fs_hz, code_length=code_length,
        window=n0 + track["window_margin"], n0=n0,
        el_shift=max(1, int(round(el * fs_hz / code_rate_hz))),
        lock_threshold=track["lock_threshold"],
        max_lost_epochs=track["max_lost_epochs"],
        pll_tau1=p1, pll_tau2=p2, dll_tau1=d1, dll_tau2=d2,
        dt=track["integration_s"] * code_period_ms)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _fma(a, b, c, dtype):
    """a * b + c rounded once to ``dtype``."""
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else float(x)
    return (f64(a) * f64(b) + f64(c)).to(dtype)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    x = torch.nan_to_num(x.double(), nan=0.0, posinf=2.0 ** 31,
                         neginf=-2.0 ** 31)
    return x.clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def _cycles_to_step(cycles: torch.Tensor) -> torch.Tensor:
    frac = cycles - torch.floor(cycles)
    return torch.clamp(torch.round(frac.double() * U32).to(torch.int64), 0,
                       MASK32)


def _state_tensors(state: dict, dtype) -> dict:
    """The host ledger as tensors: u32 fields in int64, floats in
    ``dtype``."""
    out = {}
    for f in FIELDS:
        a = np.asarray(state[f])
        if f in ("carr_acc", "chip_frac_u32"):
            out[f] = torch.from_numpy(a.astype(np.int64))
        elif a.dtype == np.float32:
            out[f] = torch.from_numpy(a.copy()).to(dtype)
        elif a.dtype == np.bool_:
            out[f] = torch.from_numpy(a.copy())
        else:
            out[f] = torch.from_numpy(a.astype(np.int32))
    return out


def epoch(p: Params, codes, st: dict, re, im, limit: int, dtype):
    """One epoch for every channel: (new state, telemetry) dicts."""
    block_len = re.shape[0]
    inv_fs = _f32(np.float32(1.0) / np.float32(p.fs_hz))
    rate = st["code_rate"]
    fs_l = _f32(np.float32(p.fs_hz) * np.float32(p.code_length))
    n_t_f = torch.round(torch.full_like(rate, fs_l)
                        / torch.clamp(rate, min=1.0))
    n_t = _to_i32(n_t_f)
    can = (st["active"] & (st["offset"] >= 0)
           & (st["offset"] + p.window <= limit))
    start = torch.clamp(st["offset"], 0, block_len - p.window)

    carr_step = _cycles_to_step(st["carr_freq"] * inv_fs)
    cps = (rate * inv_fs).to(dtype)
    frac_f = (st["chip_frac_u32"].double() / U32).to(dtype)

    # E/P/L: one gather over the chip ramp extended by el_shift samples
    w, sh = p.window, p.el_shift
    idx = start.to(torch.int64)[:, None] + torch.arange(w)
    wre, wim = re[idx], im[idx]
    j_f = (torch.arange(w + 2 * sh, dtype=torch.float64) - sh)[None, :]
    cp = _fma(j_f, cps[:, None], frac_f[:, None], dtype)
    code_idx = torch.remainder(st["chip_int"].to(torch.int64)[:, None]
                               + torch.floor(cp.double()).to(torch.int64),
                               codes.shape[1])
    chips = torch.gather(codes, 1, code_idx)
    lane = torch.arange(w, dtype=torch.int64)[None, :]
    phase = (st["carr_acc"][:, None] + lane * carr_step[:, None]) & MASK32
    theta = phase.to(dtype) * _f32(TWO_PI / U32)
    c, s = torch.cos(theta), torch.sin(theta)
    mask = lane < n_t[:, None]
    xre = torch.where(mask, wre * c + wim * s, 0.0).to(dtype)
    xim = torch.where(mask, wim * c - wre * s, 0.0).to(dtype)

    def dot(x, y):
        return (x * y).sum(-1)
    early, prompt, late = (chips[:, 2 * sh:2 * sh + w], chips[:, sh:sh + w],
                           chips[:, :w])
    i_e, q_e = dot(xre, early), dot(xim, early)
    i_p, q_p = dot(xre, prompt), dot(xim, prompt)
    i_l, q_l = dot(xre, late), dot(xim, late)

    power = i_p * i_p + q_p * q_p
    locked = power > p.lock_threshold
    safe_ip = torch.where(torch.abs(i_p) < 1e-12,
                          torch.full_like(i_p, 1e-12), i_p)
    pll_err = torch.atan(q_p / safe_ip) * (1.0 / (2.0 * np.pi))
    carr_nco = pll_err * (p.dt / p.pll_tau1) + (
        pll_err - st["carr_err"]) * (p.pll_tau2 / p.pll_tau1)
    new_cf = st["carr_freq"] + carr_nco
    pow_e = torch.sqrt(i_e * i_e + q_e * q_e)
    pow_l = torch.sqrt(i_l * i_l + q_l * q_l)
    el_sum = pow_e + pow_l
    dll_err = torch.where(el_sum > 0.0,
                          (pow_e - pow_l) / torch.clamp(el_sum, min=1e-12),
                          torch.zeros_like(el_sum))
    code_nco = dll_err * (p.dt / p.dll_tau1) + (
        dll_err - st["code_err"]) * (p.dll_tau2 / p.dll_tau1)
    new_cr = rate + code_nco

    upd = can & locked
    new_cf = torch.where(upd, new_cf, st["carr_freq"])
    new_ce = torch.where(upd, pll_err, st["carr_err"])
    new_cr = torch.where(upd, new_cr, rate)
    new_de = torch.where(upd, dll_err, st["code_err"])

    n64 = n_t.to(torch.int64)
    new_acc = (st["carr_acc"] + ((n64 & MASK32) * carr_step & MASK32)) \
        & MASK32
    code_step = _cycles_to_step(cps)
    new_frac = (st["chip_frac_u32"] + n64 * code_step) & MASK32
    new_frac_f = (new_frac.double() / U32).to(dtype)
    est = _fma(n_t_f, cps, frac_f, dtype)
    carry = torch.round(est - new_frac_f).to(torch.int32)
    chip = st["chip_int"] + carry
    chip = torch.where(chip >= p.code_length, chip - p.code_length, chip)
    chip = torch.where(chip >= p.code_length, chip - p.code_length, chip)

    new_lost = torch.where(locked, 0, st["lost_count"] + 1)
    lost_event = can & (new_lost >= p.max_lost_epochs)
    survives = can & ~lost_event

    def sel(new, old):
        return torch.where(can, new, old)

    def live(new, old):
        return torch.where(survives, new,
                           torch.where(lost_event, torch.zeros_like(old),
                                       old))

    new = dict(
        active=st["active"] & ~lost_event,
        prn_idx=torch.where(lost_event, -1, st["prn_idx"]),
        offset=sel(st["offset"] + n_t, st["offset"]),
        epochs=sel(st["epochs"] + 1, st["epochs"]),
        lost_count=torch.where(lost_event, 0, sel(new_lost,
                                                  st["lost_count"])),
        carr_freq=live(new_cf, st["carr_freq"]),
        carr_acc=sel(new_acc, st["carr_acc"]),
        carr_err=live(new_ce, st["carr_err"]),
        code_rate=live(new_cr, rate),
        chip_int=sel(chip, st["chip_int"]),
        chip_frac_u32=sel(new_frac, st["chip_frac_u32"]),
        code_err=live(new_de, st["code_err"]),
        lock_ema=torch.where(lost_event, torch.zeros_like(st["lock_ema"]),
                             st["lock_ema"]),
    )
    telem = dict(
        processed=can, i_e=i_e, q_e=q_e, i_p=i_p, q_p=q_p, i_l=i_l, q_l=q_l,
        power=power, locked=upd, lost_event=lost_event, pll_err=pll_err,
        dll_err=dll_err, carr_freq=new["carr_freq"],
        code_rate=new["code_rate"], start_offset=st["offset"],
        epoch_index=st["epochs"],
        chip_phase=st["chip_int"].to(dtype) + frac_f)
    return new, telem


def track_block(p: Params, codes: torch.Tensor, state: dict, re, im,
                n_epochs: int, valid_len: int, dtype=torch.float32):
    """``n_epochs`` epochs over one block ``re``/``im`` (host tensors)
    from the ledger ``state``; returns {field: [T, C] numpy}."""
    st = _state_tensors(state, dtype)
    re, im = re.to(dtype), im.to(dtype)
    codes = codes.to(dtype)
    limit = min(int(re.shape[0]), int(valid_len))
    rows = []
    for _ in range(n_epochs):
        st, tl = epoch(p, codes, st, re, im, limit, dtype)
        rows.append(tl)
    return {f: torch.stack([r[f] for r in rows]).float().numpy()
            if rows[0][f].is_floating_point()
            else torch.stack([r[f] for r in rows]).numpy() for f in TELEM}


class Tracker:
    """A branch's scanned tracker, from its signal, its branch
    configuration, the stream's rate and its sample layout."""

    def __init__(self, sig, d: dict, fs: float, lay):
        if sig.boc:
            raise ValueError("the scanned reference is BPSK only")
        self.lay = lay
        self.p = params(d["track"], fs, sig.code_length, sig.code_rate_hz,
                        sig.code_period_ms)
        self.table = torch.from_numpy(np.stack(
            [sig.table(p) for p in range(1, d["acq"]["n_prn"] + 1)]).astype(
                np.float32))

    def run(self, st: dict, re, im, control: bool, follow=None) -> dict:
        """One block and its catch-up epoch from the ledger ``st``
        (``track_block``), in float32 or the control's bfloat16
        (``follow`` does not apply: the tracker has no supersteps)."""
        lay = self.lay
        codes = self.table[np.maximum(np.asarray(st["prn_idx"]), 0)]
        return track_block(
            self.p, codes, st, re, im, lay.epochs + 1,
            lay.history + lay.block,
            dtype=torch.bfloat16 if control else torch.float32)
