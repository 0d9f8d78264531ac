"""Plain reference of the fused block tracker, the benchmark's frozen
copy of its plain PyTorch versions: one block of T epochs per channel
from the exact ledger, on the "mxu" layout (K-epoch supersteps at held
NCO rates, each epoch's carrier-mixed window rounded to bfloat16 and
correlated against a bank of nominal-rate replica rows at integer
sample shifts, the prompt row picked by the code phase) or the "seg"
layout (per-epoch updates on a gathered segment, float32, the prompt
row picked the same way).

Per block: the host re-anchor (whole code periods skipped to the first
start past the preroll, channels that cannot fit T epochs deferred, the
state matrix, 128-aligned window starts, replica anchors and lane
shifts), the replica rows gathered from a tiled nominal-rate sampled
code, the block's epochs, and the telemetry as the receiver reports it
(start samples, epoch counts, chip phases).

``rnd`` rounds the correlator's operands: bfloat16 for the mxu tile and
nothing on seg is the configuration's precision; the control passes
float8 (e4m3) for the mxu tile and bfloat16 for seg's mixed window
(``rounding``). ``Tracker`` is the module's face as a configuration's
tracking reference (``reference/__init__.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

U32 = 4294967296.0
TWO_PI = 6.283185307179586
N_FIELDS = 128
N_DRIFT = 5


def bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def f8(x):
    return x.to(torch.float8_e4m3fn).to(torch.float32)


def as_is(x):
    return x


def fma(a, b, c):
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else float(x)
    return (f64(a) * f64(b) + f64(c)).float()


def choose_k(t_epochs: int, k_max: int = 16):
    for k in range(min(k_max, t_epochs // 2), 0, -1):
        if t_epochs % (2 * k) == 0:
            return k
    return None


def _taus(bw, damping, gain):
    w = bw * 8.0 * damping / (4.0 * damping * damping + 1.0)
    return gain / (w * w), 2.0 * damping / w


@dataclasses.dataclass
class Geometry:
    """One branch's fused tracker: its layout, window and kernel
    constants, from the configuration."""

    layout: str
    n0: int
    t_epochs: int
    wp: int
    n_rows: int
    el_shift: int
    el_pad: int
    max_offset: int
    k_epochs: int | None
    l_seg: int | None
    code_len: float
    code_rate: float
    kw: dict

    @classmethod
    def create(cls, d: dict, fs: float, code_len: int, code_rate: float,
               carrier_hz: float, code_period_ms: int, boc: bool,
               buf_len: int) -> "Geometry":
        tr = d["track"]
        n0 = int(round(fs * code_period_ms / 1000.0))
        t = d["block_ms"] // code_period_ms
        el = tr["early_late_chips"]
        if boc:
            el = min(el, 0.25)
        el_shift = max(1, int(round(el * fs / code_rate)))
        window = n0 + tr["window_margin"]
        costas = tr["lock_mode"] == "costas"
        layout = tr["fused_layout"]
        if layout == "auto":
            layout = "mxu"
        if layout == "mxu" and choose_k(t, 2 if costas else 8) is None:
            layout = "direct"
        if layout == "direct" and choose_k(t) is None:
            layout = "seg"
        if layout not in ("mxu", "seg"):
            raise ValueError(f"no reference for the {layout!r} layout")
        extra = 384 + 2 * el_shift if layout == "mxu" else 256
        wp = ((window + extra + 63 + 127) // 128) * 128
        rows = N_DRIFT + 2 * el_shift
        n_rows = (8 if rows <= 8 else rows) if layout == "mxu" else N_DRIFT
        half = (n_rows - 1) // 2
        el_pad = el_shift + half
        k = l_seg = None
        if layout == "mxu":
            k = choose_k(t, 2 if costas else 8)
            max_offset = buf_len - (t - 1) * n0 - wp + el_pad - 1
        else:
            last = ((t - 1) * n0 // 128) * 128 + wp
            l_seg = ((last + 127) // 128) * 128
            max_offset = buf_len - l_seg + el_pad - 1
        p1, p2 = _taus(tr["pll_bandwidth_hz"], tr["pll_damping"],
                       tr["pll_gain"])
        d1, d2 = _taus(tr["dll_bandwidth_hz"], tr["dll_damping"],
                       tr["dll_gain"])
        dt = tr["integration_s"]
        kw = dict(
            n0=n0, fs=fs, code_len=float(code_len),
            lock_threshold=tr["lock_threshold"],
            max_lost=tr["max_lost_epochs"],
            pll_c1=dt / p1, pll_c2=p2 / p1, dll_c1=dt / d1, dll_c2=d2 / d1,
            el_shift=el_shift,
            aiding_scale=(code_rate / carrier_hz if tr["carrier_aiding"]
                          else 0.0),
            if_freq=0.0, lock_mode=tr["lock_mode"],
            costas_thr=tr["costas_lock_threshold"],
            interp=tr["interp_code"], t_epochs=t, wp=wp)
        if k is not None:
            kw["k_epochs"] = k
        return cls(layout, n0, t, wp, n_rows, el_shift, el_pad, max_offset,
                   k, l_seg, float(code_len), code_rate, kw)


def sampled_table(sample_code, n_prn: int, n0: int, window: int
                  ) -> torch.Tensor:
    """[P, 2*n0 + W + 768] nominal-rate sampled codes, tiled."""
    need = 2 * n0 + window + 768
    reps = int(np.ceil(need / n0)) + 1
    return torch.from_numpy(np.stack(
        [np.tile(sample_code(p), reps)[:need]
         for p in range(1, n_prn + 1)]).astype(np.float32))


def anchor_block(g: Geometry, state: dict, fs: float) -> dict:
    """The host re-anchor of one block from the exact ledger."""
    c = int(np.asarray(state["active"]).shape[0])
    active0 = np.asarray(state["active"])
    offset0 = np.asarray(state["offset"]).astype(np.int64).copy()
    epochs0 = np.asarray(state["epochs"]).astype(np.int64)
    cp0 = (np.asarray(state["chip_int"]).astype(np.float64)
           + np.asarray(state["chip_frac_u32"]).astype(np.float64) / U32)
    low = active0 & (offset0 < g.el_pad)
    n_skip = np.where(low, -((offset0 - g.el_pad) // g.n0), 0)
    offset0 = offset0 + n_skip * g.n0
    epochs0 = epochs0 + n_skip
    eligible = active0 & (offset0 <= g.max_offset)
    mat = np.zeros((c, N_FIELDS), np.float32)
    mat[:, 0] = np.asarray(state["carr_freq"])
    mat[:, 1] = np.asarray(state["carr_acc"]).astype(np.float64) / U32
    mat[:, 2] = np.asarray(state["carr_err"])
    rate = np.asarray(state["code_rate"]).astype(np.float32)
    mat[:, 3] = np.where(rate > 0, rate, np.float32(g.code_rate))
    mat[:, 5] = np.asarray(state["code_err"])
    mat[:, 6] = np.asarray(state["lost_count"])
    mat[:, 7] = eligible.astype(np.float32)
    mat[:, 11] = np.asarray(state["lock_ema"])
    rate_eff = mat[:, 3].astype(np.float32)
    if g.kw["aiding_scale"]:
        rate_eff = rate_eff + (mat[:, 0] - np.float32(0.0)) * np.float32(
            g.kw["aiding_scale"])
    dc0 = (rate_eff / np.float32(fs)).astype(np.float32)
    s_anchor = np.floor(cp0.astype(np.float32) / dc0)
    mat[:, 10] = cp0.astype(np.float32) - s_anchor.astype(np.float32) * dc0
    anchor = np.mod(s_anchor, g.n0).astype(np.int32)
    a_c = ((offset0 - g.el_pad) // 128) * 128
    starts = np.where(eligible, np.maximum(a_c, 0), 0)
    mat[:, 9] = np.where(eligible, offset0 - starts,
                         g.el_pad).astype(np.float32)
    mat[:, 12] = starts.astype(np.float32)
    mat[:, 13] = anchor.astype(np.float32)
    return dict(mat=mat, starts=starts.astype(np.int32), anchor=anchor,
                lane_shift=(mat[:, 9] - np.float32(g.el_pad)).astype(
                    np.int32),
                eligible=eligible, offset0=offset0, epochs0=epochs0, cp0=cp0)


def build_replicas(codes3x, el_shift, n0, wp, n_drift, anchor, lane_shift):
    half = (n_drift - 1) // 2
    el_pad = el_shift + half
    c = codes3x.shape[0]
    s_i = torch.from_numpy(np.asarray(anchor, np.int64))
    s_i = torch.where(s_i >= n0, s_i - n0, s_i)
    s_i = torch.where(s_i < 0, s_i + n0, s_i)
    shift = torch.from_numpy(np.asarray(lane_shift, np.int64))
    base = s_i + n0 - el_pad + half - shift
    rows = torch.arange(n_drift, dtype=torch.int64)
    lanes = torch.arange(wp, dtype=torch.int64)
    idx = base[:, None, None] - rows[None, :, None] + lanes[None, None, :]
    return torch.gather(codes3x.to(torch.float32), 1,
                        idx.reshape(c, -1)).reshape(c, n_drift, wp)


def _atan_poly(x):
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    ax = torch.abs(x)
    inv = ax > 1.0
    z = torch.where(inv, 1.0 / torch.maximum(ax, f(1e-20)), ax)
    t = z * z
    p = z * (f(0.9998660) + t * (f(-0.3302995) + t * (f(0.1801410)
             + t * (f(-0.0851330) + f(0.0208351) * t))))
    r = torch.where(inv, f(np.pi / 2) - p, p)
    return torch.where(x < 0.0, -r, r)


def superstep(st, j, win_re, win_im, bank, *, k_epochs, wp, n0, fs,
               code_len, lock_threshold, max_lost, pll_c1, pll_c2, dll_c1,
               dll_c2, el_shift, aiding_scale, if_freq, lock_mode,
               costas_thr, interp, rnd):
    """One K-epoch superstep (power lock) from [C, span] windows:
    (new state [C, 128], telemetry [K, C, 21])."""
    if lock_mode != "power":
        raise ValueError("the reference holds the power lock detector")
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    c_channels = st.shape[0]
    r_rows = bank.shape[1]
    half_r = (r_rows - 1) // 2
    kk = k_epochs * n0
    fs_f = f(fs)

    def col(k):
        return st[:, k:k + 1]

    carr_freq, carr_phase, carr_err0 = col(0), col(1), col(2)
    code_rate, chip_res0, code_err0 = col(3), col(4), col(5)
    lost0, active0, drift0 = col(6), col(7), col(8)
    woff, frac0, lock_ema0 = col(9), col(10), col(11)
    if aiding_scale != 0.0:
        rate_eff = code_rate + (carr_freq - f(if_freq)) * f(aiding_scale)
    else:
        rate_eff = code_rate
    inv_fs = f(1.0) / fs_f
    dc = rate_eff * inv_fs
    n_t_f = torch.round(fs_f * f(code_len) / rate_eff)
    step = carr_freq * inv_fs
    adv = step * n_t_f
    d_drift = n_t_f - f(n0)
    d_chip = (dc.double() * n_t_f.double() - code_len).float()
    rem_j = j * kk - (j * kk // 128) * 128
    rem_j_f = f(rem_j)

    w128 = wp // 128
    lane = torch.arange(wp, dtype=torch.float32)[None, :]
    q128 = torch.arange(128, dtype=torch.float32)[None, :]
    q_w = torch.arange(w128, dtype=torch.float32)[None, :]
    th_b = step * q128
    th_b = (th_b - torch.floor(th_b)) * f(TWO_PI)
    b_c, b_s = torch.cos(th_b), torch.sin(th_b)
    tiles = []
    for e in range(k_epochs):
        a_e = (e * n0 // 128) * 128
        rem_e = e * n0 - a_e
        ef = f(e)
        drift_e = drift0 + ef * d_drift
        rem_i = rem_e + rem_j
        sl = woff + drift_e + f(rem_e) + rem_j_f
        phi0 = carr_phase + ef * adv - sl * step
        th_a = phi0 + (step * f(128.0)) * q_w
        th_a = (th_a - torch.floor(th_a)) * f(TWO_PI)
        a_c, a_s = torch.cos(th_a), torch.sin(th_a)
        ra_c = a_c.repeat_interleave(128, dim=1)
        ra_s = a_s.repeat_interleave(128, dim=1)
        tb_c, tb_s = b_c.repeat(1, w128), b_s.repeat(1, w128)
        cth = ra_c * tb_c - ra_s * tb_s
        sth = ra_s * tb_c + ra_c * tb_s
        wre = win_re[:, a_e:a_e + wp]
        wim = win_im[:, a_e:a_e + wp]
        mask = ((lane >= sl) & (lane < sl + n_t_f)).to(torch.float32)
        m_re = (wre * cth + wim * sth) * mask
        m_im = (wim * cth - wre * sth) * mask
        tiles.append(rnd(torch.roll(m_re, -rem_i, dims=1)))
        tiles.append(rnd(torch.roll(m_im, -rem_i, dims=1)))
    tile = torch.stack(tiles[0::2] + tiles[1::2], dim=1)
    corr = torch.bmm(tile, rnd(bank.to(torch.float32)).transpose(1, 2))
    corr_re, corr_im = corr[:, :k_epochs], corr[:, k_epochs:]

    ef_all = torch.arange(k_epochs, dtype=torch.float32)[None, :]
    drift_all = drift0 + ef_all * d_drift
    chip_all = chip_res0 + ef_all * d_chip
    qq_all = (chip_all + frac0) / dc
    qf_all = torch.floor(qq_all)
    shift_all = drift_all - qf_all
    idx_p_all = f(half_r) + shift_all
    r3 = torch.arange(r_rows, dtype=torch.float32)[None, None, :]

    def pick(corr3, idx):
        m = (r3 == idx[:, :, None]).to(torch.float32)
        return torch.sum(corr3 * m, dim=2)

    if interp:
        f_sub_all = qq_all - qf_all

        def pick_b(corr3, idx):
            return ((1.0 - f_sub_all) * pick(corr3, idx)
                    + f_sub_all * pick(corr3, idx - 1.0))
    else:
        pick_b = pick
    el_f = f(el_shift)
    i_p_all = pick_b(corr_re, idx_p_all)
    q_p_all = pick_b(corr_im, idx_p_all)
    i_e_all = pick_b(corr_re, idx_p_all - el_f)
    q_e_all = pick_b(corr_im, idx_p_all - el_f)
    i_l_all = pick_b(corr_re, idx_p_all + el_f)
    q_l_all = pick_b(corr_im, idx_p_all + el_f)

    power_all = i_p_all * i_p_all + q_p_all * q_p_all
    safe_ip = torch.where(torch.abs(i_p_all) < 1e-12, f(1e-12), i_p_all)
    pll_err_all = _atan_poly(q_p_all / safe_ip) * f(1.0 / TWO_PI)
    pow_e_all = torch.sqrt(i_e_all * i_e_all + q_e_all * q_e_all)
    pow_l_all = torch.sqrt(i_l_all * i_l_all + q_l_all * q_l_all)
    el_sum = pow_e_all + pow_l_all
    dll_err_all = torch.where(
        el_sum > 0.0,
        (pow_e_all - pow_l_all) / torch.maximum(el_sum, f(1e-12)), f(0.0))

    telem = torch.zeros((k_epochs, c_channels, 21), dtype=torch.float32)

    def put(e, k, v):
        telem[e, :, k] = v.reshape(c_channels)

    zero = torch.zeros_like(carr_freq)
    locked_all = power_all > f(lock_threshold)
    kf = k_epochs
    act0_b = active0 > 0.5
    e_row = torch.arange(kf)[None, :]
    e_f = e_row.to(torch.float32)
    j3 = torch.arange(kf)[None, None, :]
    e3 = torch.arange(kf)[None, :, None]
    lk3 = locked_all[:, None, :]
    neg1 = torch.tensor(-1)
    last_lk = torch.amax(torch.where((j3 <= e3) & lk3, j3, neg1), dim=2)
    lo_all = torch.where(last_lk >= 0, (e_row - last_lk).to(torch.float32),
                         lost0 + e_f + 1.0)
    death = lo_all >= f(max_lost)
    d_idx = torch.amin(torch.where(death, e_row, torch.tensor(kf)), dim=1,
                       keepdim=True)
    act_all = act0_b & (e_row <= d_idx)
    upd_all = act_all & locked_all
    wr_all = act_all.to(torch.float32)
    upd_f = upd_all.to(torch.float32)
    emit_lost = (act0_b & (e_row == d_idx)).to(torch.float32)
    n_act = torch.sum(wr_all, dim=1, keepdim=True)
    last_u = torch.amax(torch.where((j3 < e3) & upd_all[:, None, :], j3,
                                    neg1), dim=2)
    oh_u = (j3 == last_u[:, :, None]).to(torch.float32)
    ce_all = torch.where(last_u >= 0, torch.sum(
        oh_u * pll_err_all[:, None, :], dim=2), carr_err0)
    de_all = torch.where(last_u >= 0, torch.sum(
        oh_u * dll_err_all[:, None, :], dim=2), code_err0)
    carr_nco_all = pll_err_all * f(pll_c1) + (pll_err_all - ce_all) * f(
        pll_c2)
    code_nco_all = dll_err_all * f(dll_c1) + (dll_err_all - de_all) * f(
        dll_c2)
    upd_nco_c = upd_f * carr_nco_all
    upd_nco_d = upd_f * code_nco_all
    sum_c, sum_d = torch.zeros_like(carr_freq), torch.zeros_like(code_rate)
    cf_steps, cr_steps = [], []
    for e in range(kf):
        sum_c = sum_c + upd_nco_c[:, e:e + 1]
        sum_d = sum_d + upd_nco_d[:, e:e + 1]
        cf_steps.append(carr_freq + sum_c)
        cr_steps.append(code_rate + sum_d)
    cf_f = carr_freq + sum_c
    cr_f = code_rate + sum_d
    cf_steps = torch.cat(cf_steps, dim=1)
    cr_steps = torch.cat(cr_steps, dim=1)
    u_last = torch.amax(torch.where(upd_all, e_row, neg1), dim=1,
                        keepdim=True)
    oh_k = (e_row == u_last).to(torch.float32)
    ce_f = torch.where(u_last >= 0, torch.sum(oh_k * pll_err_all, dim=1,
                                              keepdim=True), carr_err0)
    de_f = torch.where(u_last >= 0, torch.sum(oh_k * dll_err_all, dim=1,
                                              keepdim=True), code_err0)
    oh_lo = (e_row == torch.clamp(d_idx, max=kf - 1)).to(torch.float32)
    lo_f = torch.where(act0_b, torch.sum(oh_lo * lo_all, dim=1,
                                         keepdim=True), lost0)
    died_now = act0_b & (d_idx < kf)
    ac_f = torch.where(died_now, zero, active0)
    died_any = died_now | (~act0_b & (lost0 >= f(max_lost)))
    le_f = torch.where(died_any, zero, lock_ema0)
    for e in range(kf):
        wr_e = wr_all[:, e:e + 1]
        for k, v in ((0, i_e_all), (1, q_e_all), (2, i_p_all),
                     (3, q_p_all), (4, i_l_all), (5, q_l_all),
                     (6, power_all), (8, pll_err_all), (9, dll_err_all),
                     (14, chip_all)):
            put(e, k, v[:, e:e + 1] * wr_e)
        put(e, 7, upd_f[:, e:e + 1])
        put(e, 10, cf_steps[:, e:e + 1])
        put(e, 11, cr_steps[:, e:e + 1])
        put(e, 12, n_t_f)
        put(e, 13, drift_all[:, e:e + 1])
        put(e, 15, emit_lost[:, e:e + 1])
        put(e, 16, wr_e)
    ncp = carr_phase + n_act * adv
    new = torch.zeros_like(st)
    for k, v in ((0, cf_f), (1, ncp - torch.floor(ncp)), (2, ce_f),
                 (3, cr_f), (4, chip_res0 + n_act * d_chip), (5, de_f),
                 (6, lo_f), (7, ac_f), (8, drift0 + n_act * d_drift),
                 (9, woff), (10, frac0), (11, le_f)):
        new[:, k] = v.reshape(c_channels)
    return new, telem


def _epoch(st, wre, wim, reps, start_lane, rem_i, *, wp, n0, fs, code_len,
           lock_threshold, max_lost, pll_c1, pll_c2, dll_c1, dll_c2,
           el_shift, aiding_scale, if_freq, lock_mode, costas_thr, interp,
           rnd):
    """One per-epoch step (power lock) of the seg layout: (new state,
    telemetry row [C, 17])."""
    if lock_mode != "power":
        raise ValueError("the reference holds the power lock detector")
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    c_channels = st.shape[0]
    n_drift = reps.shape[1]
    half = (n_drift - 1) // 2

    def col(k):
        return st[:, k:k + 1]

    carr_freq, carr_phase, carr_err = col(0), col(1), col(2)
    code_rate, chip_res, code_err = col(3), col(4), col(5)
    lost, active, drift = col(6), col(7), col(8)
    woff, frac0, lock_ema = col(9), col(10), col(11)
    fs_f = f(fs)
    inv_fs = f(1.0) / fs_f
    if aiding_scale != 0.0:
        code_rate_eff = code_rate + (carr_freq - f(if_freq)) * f(
            aiding_scale)
    else:
        code_rate_eff = code_rate
    dc = code_rate_eff * inv_fs
    n_t_f = torch.round(fs_f * f(code_len) / code_rate_eff)
    lane = torch.arange(wp, dtype=torch.float32)[None, :]
    mask = ((lane >= start_lane) & (lane < start_lane + n_t_f)).to(
        torch.float32)
    step = carr_freq * inv_fs
    phi0 = carr_phase - start_lane * step
    w128 = wp // 128
    q_w = torch.arange(w128, dtype=torch.float32)[None, :]
    q128 = torch.arange(128, dtype=torch.float32)[None, :]
    th_a = phi0 + (step * f(128.0)) * q_w
    th_a = (th_a - torch.floor(th_a)) * f(TWO_PI)
    th_b = step * q128
    th_b = (th_b - torch.floor(th_b)) * f(TWO_PI)
    a_c, a_s = torch.cos(th_a), torch.sin(th_a)
    b_c, b_s = torch.cos(th_b), torch.sin(th_b)
    ra_c = a_c.repeat_interleave(128, dim=1)
    ra_s = a_s.repeat_interleave(128, dim=1)
    tb_c, tb_s = b_c.repeat(1, w128), b_s.repeat(1, w128)
    cth = ra_c * tb_c - ra_s * tb_s
    sth = ra_s * tb_c + ra_c * tb_s
    re_w = rnd((wre * cth + wim * sth) * mask)
    im_w = rnd((wim * cth - wre * sth) * mask)
    q = (chip_res + frac0) / dc
    q_floor = torch.floor(q)
    shift = drift - q_floor
    d_f = torch.arange(n_drift, dtype=torch.float32)[None, :] - f(half)
    sel_d = (shift == d_f).to(torch.float32)
    if interp:
        f_sub = q - q_floor
        sel_m = (shift == d_f + 1.0).to(torch.float32)
        w = (1.0 - f_sub) * sel_d + f_sub * sel_m
    else:
        w = sel_d
    prompt = torch.sum(w[:, :, None] * reps, dim=1)
    prompt = torch.roll(prompt, rem_i, dims=1)
    early = torch.roll(prompt, -el_shift, dims=1)
    late = torch.roll(prompt, el_shift, dims=1)

    def corr(x, y):
        return torch.sum(x * y, dim=1, keepdim=True)

    i_e, q_e = corr(re_w, early), corr(im_w, early)
    i_p, q_p = corr(re_w, prompt), corr(im_w, prompt)
    i_l, q_l = corr(re_w, late), corr(im_w, late)
    power = i_p * i_p + q_p * q_p
    new_lock_ema = lock_ema
    locked = power > f(lock_threshold)
    safe_ip = torch.where(torch.abs(i_p) < 1e-12, f(1e-12), i_p)
    pll_err = _atan_poly(q_p / safe_ip) * f(1.0 / TWO_PI)
    carr_nco = pll_err * f(pll_c1) + (pll_err - carr_err) * f(pll_c2)
    pow_e = torch.sqrt(i_e * i_e + q_e * q_e)
    pow_l = torch.sqrt(i_l * i_l + q_l * q_l)
    el_sum = pow_e + pow_l
    dll_err = torch.where(
        el_sum > 0.0, (pow_e - pow_l) / torch.maximum(el_sum, f(1e-12)),
        f(0.0))
    code_nco = dll_err * f(dll_c1) + (dll_err - code_err) * f(dll_c2)
    act = active > 0.5
    upd = act & locked
    new_carr_freq = torch.where(upd, carr_freq + carr_nco, carr_freq)
    new_carr_err = torch.where(upd, pll_err, carr_err)
    new_code_rate = torch.where(upd, code_rate + code_nco, code_rate)
    new_code_err = torch.where(upd, dll_err, code_err)
    zero = torch.zeros_like(lost)
    new_lost = torch.where(act, torch.where(locked, zero, lost + 1.0), lost)
    died = new_lost >= f(max_lost)
    new_active = torch.where(died, zero, active)
    ncp = fma(step, n_t_f, carr_phase)
    new_carr_phase = ncp - torch.floor(ncp)
    new_chip_res = fma(dc, n_t_f, chip_res) - f(code_len)
    new_drift = drift + n_t_f - f(n0)

    def sel(new, old):
        return torch.where(act, new, old)

    new = torch.zeros_like(st)
    for k, v in ((0, sel(new_carr_freq, carr_freq)),
                 (1, sel(new_carr_phase, carr_phase)),
                 (2, sel(new_carr_err, carr_err)),
                 (3, sel(new_code_rate, code_rate)),
                 (4, sel(new_chip_res, chip_res)),
                 (5, sel(new_code_err, code_err)), (6, sel(new_lost, lost)),
                 (7, new_active), (8, sel(new_drift, drift)), (9, woff),
                 (10, frac0), (11, torch.where(died, zero, new_lock_ema))):
        new[:, k] = v.reshape(c_channels)
    wr = act.to(torch.float32)
    row = torch.cat([
        i_e * wr, q_e * wr, i_p * wr, q_p * wr, i_l * wr, q_l * wr,
        power * wr, upd.to(torch.float32), pll_err * wr, dll_err * wr,
        sel(new_carr_freq, carr_freq), sel(new_code_rate, code_rate),
        n_t_f, drift, chip_res * wr, (died & act).to(torch.float32), wr,
    ], dim=1)
    return new, row


def follow_loops(st: torch.Tensor, prog: dict, e0: int, e1: int
                 ) -> torch.Tensor:
    """The state ``st`` after epochs [e0, e1) with the loops' columns as
    the program reported them at its last of those epochs: carrier
    frequency and code rate; the discriminators of the last epoch that
    updated them (channels with none keep theirs)."""
    st = st.clone()
    last = e1 - 1
    st[:, 0] = torch.from_numpy(np.asarray(prog["carr_freq"][last],
                                           np.float32))
    st[:, 3] = torch.from_numpy(np.asarray(prog["code_rate"][last],
                                           np.float32))
    upd = np.asarray(prog["locked"][e0:e1], bool)
    for c in np.nonzero(upd.any(axis=0))[0]:
        e = e0 + int(np.nonzero(upd[:, c])[0][-1])
        st[c, 2] = float(np.float32(prog["pll_err"][e, c]))
        st[c, 5] = float(np.float32(prog["dll_err"][e, c]))
    return st


def track_block(g: Geometry, table: torch.Tensor, state: dict,
                re: torch.Tensor, im: torch.Tensor, fs: float,
                rnd=None, follow: dict | None = None) -> dict:
    """One fused block from the ledger ``state`` over the window
    ``re``/``im`` (host f32); returns the block's telemetry {field:
    [T, C]} as the receiver reports it. With ``follow`` (the program's
    telemetry of the block), each superstep after the first starts from
    the loops as the program left them (``follow_loops``)."""
    anc = anchor_block(g, state, fs)
    codes = table[np.maximum(np.asarray(state["prn_idx"]), 0)]
    reps = build_replicas(codes, g.el_shift, g.n0, g.wp, g.n_rows,
                          anc["anchor"], anc["lane_shift"])
    st = torch.from_numpy(anc["mat"])
    starts = torch.from_numpy(anc["starts"].astype(np.int64))
    kw = {k: v for k, v in g.kw.items() if k not in ("t_epochs",
                                                      "k_epochs")}
    rows = []
    if g.layout == "mxu":
        rnd = rnd or bf16
        k = g.k_epochs
        span = ((k - 1) * g.n0 // 128) * 128 + g.wp
        lanes = torch.arange(span, dtype=torch.int64)
        for j in range(g.t_epochs // k):
            if follow is not None and j:
                st = follow_loops(st, follow, (j - 1) * k, j * k)
            off = (j * k * g.n0 // 128) * 128
            idx = starts[:, None] + off + lanes[None, :]
            st, tl = superstep(st, j, re[idx], im[idx], reps, k_epochs=k,
                                rnd=rnd, **kw)
            rows.append(tl)
        telem = torch.cat(rows, dim=0)
    else:
        rnd = rnd or as_is
        idx = starts[:, None] + torch.arange(g.l_seg, dtype=torch.int64)
        seg_re, seg_im = re[idx], im[idx]
        for t in range(g.t_epochs):
            a = (t * g.n0 // 128) * 128
            rem = t * g.n0 - a
            start_lane = (st[:, 9:10] + st[:, 8:9]) + float(rem)
            st, row = _epoch(st, seg_re[:, a:a + g.wp], seg_im[:, a:a + g.wp],
                             reps, start_lane, rem, rnd=rnd, **kw)
            rows.append(row)
        telem = torch.stack(rows, dim=0)
    tm = telem.numpy()
    processed = tm[:, :, 16] > 0.5
    t_idx = np.arange(g.t_epochs, dtype=np.int64)[:, None]
    return dict(
        processed=processed,
        i_e=tm[:, :, 0], q_e=tm[:, :, 1], i_p=tm[:, :, 2], q_p=tm[:, :, 3],
        i_l=tm[:, :, 4], q_l=tm[:, :, 5], power=tm[:, :, 6],
        locked=tm[:, :, 7] > 0.5, lost_event=tm[:, :, 15] > 0.5,
        pll_err=tm[:, :, 8], dll_err=tm[:, :, 9], carr_freq=tm[:, :, 10],
        code_rate=tm[:, :, 11],
        start_offset=(anc["offset0"][None, :] + t_idx * g.n0
                      + tm[:, :, 13].astype(np.int64)).astype(np.int32),
        epoch_index=(anc["epochs0"][None, :] + np.cumsum(processed, axis=0)
                     - processed).astype(np.int32),
        chip_phase=np.mod(anc["cp0"][None, :] + tm[:, :, 14],
                          g.code_len).astype(np.float32))


def rounding(layout: str, control: bool):
    """The correlator operands' rounding on ``layout``: the
    configuration's (bfloat16 mxu tile, nothing on seg), or with
    ``control`` the control's (float8 e4m3 mxu tile, bfloat16 seg)."""
    if layout == "mxu":
        return f8 if control else bf16
    return bf16 if control else as_is


class Tracker:
    """A branch's fused block tracker, from its signal, its branch
    configuration, the stream's rate and its sample layout: ``g`` its
    geometry, ``table`` its tiled sampled codes."""

    def __init__(self, sig, d: dict, fs: float, lay):
        self.fs = fs
        self.g = Geometry.create(
            d, fs, sig.code_length, sig.code_rate_hz, sig.carrier_hz,
            sig.code_period_ms, sig.boc, lay.history + lay.block)
        self.table = sampled_table(
            lambda p: sig.sample_code(p, fs), d["acq"]["n_prn"], lay.n0,
            lay.n0 + d["track"]["window_margin"])

    def run(self, st: dict, re, im, control: bool, follow=None) -> dict:
        """One block from the ledger ``st`` (``track_block``), at the
        configuration's precision or the control's."""
        return track_block(self.g, self.table, st, re, im, self.fs,
                           rnd=rounding(self.g.layout, control),
                           follow=follow)
