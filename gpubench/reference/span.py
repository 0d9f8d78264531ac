"""Plain reference of the fused tracker's multi-block scan: the blocks of
a span, each from the ledger the block before left, with the ledger
carried between them as the scan carries it on the card.

The ledger of a span is six arrays over the channels: active (0/1
f32), the window-relative offset of the next code boundary (int32),
the epoch count (int32), the chip phase as whole chips (int32) and a
fraction (f32), and seven f32 columns (carrier frequency, carrier
phase in cycles, carrier discriminator, code rate, code discriminator,
lost count, lock EMA). Per block: the offset walk and eligibility, the
block-start anchor in the kernel's f32 arithmetic, 128-aligned window
starts counted from the span stream's first sample, the replica rows,
the block's supersteps, and the absorb of the kernel state into the
ledger with the rebase past the block folded in.

The tracker's own arithmetic comes from the configuration's reference
module (``ref``, ``reference/<name>.py``, ``fused`` as a rule): its
``Tracker`` (``g``, the geometry; ``table``, the sampled codes),
``build_replicas``, ``superstep``, ``rounding``, ``fma`` and
``N_FIELDS``.

``follow`` (the judge of a program's span): each superstep after the
span's first starts from the carrier frequency and code rate the
program held in it (its telemetry), and the gap between what the
reference's own loop update gave and what the program held is the
loop gap. ``wire`` maps telemetry as the program's download carries it
(``slim2``: prompt I/Q in bfloat16, the early and late sums and the
discriminators on the first epoch of even supersteps, the rates held
per superstep).
"""
from __future__ import annotations

import numpy as np
import torch

U32 = 4294967296.0


def led_from_state(state: dict, code_rate_hz: float) -> tuple:
    """The span ledger of an exact host ledger (the receiver's
    ChannelState fields)."""
    rate = np.asarray(state["code_rate"]).astype(np.float32)
    cols = np.stack([
        np.asarray(state["carr_freq"], np.float32),
        (np.asarray(state["carr_acc"]).astype(np.float64) / U32
         ).astype(np.float32),
        np.asarray(state["carr_err"], np.float32),
        np.where(rate > 0, rate, np.float32(code_rate_hz)),
        np.asarray(state["code_err"], np.float32),
        np.asarray(state["lost_count"], np.float32),
        np.asarray(state["lock_ema"], np.float32)], axis=1)
    return (np.asarray(state["active"]).astype(np.float32),
            np.asarray(state["offset"]).astype(np.int32),
            np.asarray(state["epochs"]).astype(np.int32),
            np.asarray(state["chip_int"]).astype(np.int32),
            (np.asarray(state["chip_frac_u32"]).astype(np.float64) / U32
             ).astype(np.float32), cols)


def state_from_led(led: tuple, prn_idx) -> dict:
    """The exact host ledger a span ledger folds back into."""
    active, offset, epochs, ci, cf, cols = (np.asarray(x) for x in led)
    return dict(
        active=active > 0.5, prn_idx=np.asarray(prn_idx, np.int32),
        offset=offset.astype(np.int32), epochs=epochs.astype(np.int32),
        lost_count=cols[:, 5].astype(np.int32),
        carr_freq=cols[:, 0].astype(np.float32),
        carr_acc=np.minimum(cols[:, 1].astype(np.float64) * U32,
                            U32 - 1.0).astype(np.uint32),
        carr_err=cols[:, 2].astype(np.float32),
        code_rate=cols[:, 3].astype(np.float32),
        chip_int=ci.astype(np.int32),
        chip_frac_u32=np.minimum(cf.astype(np.float64) * U32,
                                 U32 - 1.0).astype(np.uint32),
        code_err=cols[:, 4].astype(np.float32),
        lock_ema=cols[:, 6].astype(np.float32))


def start_in_led(led: tuple, channel: int, carrier_hz: float, offset: int,
                 code_rate_hz: float) -> tuple:
    """A channel started in a span ledger, its fields as a new channel
    starts (the span path's handoff on the card)."""
    active, off, epochs, ci, cf, cols = (np.array(x, copy=True)
                                         for x in led)
    active[channel], off[channel], epochs[channel] = 1.0, offset, 0
    ci[channel], cf[channel] = 0, 0.0
    cols[channel] = (np.float32(carrier_hz), 0.0, 0.0,
                     np.float32(code_rate_hz), 0.0, 0.0, 1.0)
    return active, off, epochs, ci, cf, cols


def _t(x, dtype):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def anchor(ref, g, led: tuple, b: int, block_len: int, fs: float) -> dict:
    """Block ``b`` of a span from the ledger ``led``: the walk, the
    eligible channels, the kernel's state matrix, the window starts in
    the span stream and the replica anchors."""
    active, offset, epochs, ci, cf, cols = led
    active, cf = _t(active, torch.float32), _t(cf, torch.float32)
    offset, epochs = _t(offset, torch.int32), _t(epochs, torch.int32)
    ci, fc = _t(ci, torch.int32), _t(cols, torch.float32)
    n0, el_pad = g.n0, g.el_pad
    act = active > 0.5
    low = act & (offset < el_pad)
    n_skip = torch.where(low, torch.div(el_pad - offset + n0 - 1, n0,
                                        rounding_mode="floor"), 0)
    offset_w = (offset + n_skip * n0).to(torch.int32)
    epochs = (epochs + n_skip).to(torch.int32)
    eligible = act & (offset_w <= g.max_offset)
    rate = fc[:, 3]
    aiding = float(np.float32(g.kw["aiding_scale"]))
    rate_eff = rate + (fc[:, 0] - float(np.float32(0.0))) * aiding
    dc0 = rate_eff * float(np.float32(1.0) / np.float32(fs))
    cp0 = ci.to(torch.float32) + cf
    s_anchor = torch.floor(cp0 / dc0)
    frac0 = ref.fma(-s_anchor, dc0, cp0)
    anc = torch.remainder(s_anchor, float(n0))
    off_abs = offset_w + b * block_len
    a_abs = torch.where(eligible, torch.clamp(
        ((off_abs - el_pad) >> 7) << 7, min=0), 0)
    col9 = torch.where(eligible, (off_abs - a_abs).to(torch.float32),
                       float(el_pad))
    zero = torch.zeros_like(rate)
    mat = torch.stack([fc[:, 0], fc[:, 1], fc[:, 2], rate, zero, fc[:, 4],
                       fc[:, 5], eligible.to(torch.float32), zero, col9,
                       frac0, fc[:, 6], zero, anc], dim=1)
    mat = torch.nn.functional.pad(mat, (0, ref.N_FIELDS - 14))
    return dict(mat=mat, starts=a_abs.to(torch.int64), eligible=eligible,
                anchor=anc.to(torch.int64),
                lane_shift=(col9 - float(el_pad)).to(torch.int64),
                act=act, offset_w=offset_w, epochs=epochs, ci=ci, cf=cf,
                fc=fc)


def absorb(g, a: dict, out: torch.Tensor,
           processed: torch.Tensor, block_len: int, code_len: int
           ) -> tuple:
    """The ledger after the block: the kernel state ``out`` folded into
    ``a``'s ledger (eligible channels), offsets rebased past the
    block."""
    el, ci, cf, fc = a["eligible"], a["ci"], a["cf"], a["fc"]
    s = cf + out[:, 4]
    k = torch.floor(s)
    cf_n = torch.where(el, s - k, cf)
    ci_raw = ci + k.to(torch.int32)
    ci_wrap = torch.where(ci_raw < 0, ci_raw + code_len,
                          torch.where(ci_raw >= code_len,
                                      ci_raw - code_len, ci_raw))
    ci_n = torch.where(el, ci_wrap, ci)
    n_proc = processed.sum(dim=0, dtype=torch.int32)
    epochs_n = torch.where(el, a["epochs"] + n_proc, a["epochs"])
    offset_n = torch.where(el, a["offset_w"] + out[:, 8].to(torch.int32),
                           a["offset_w"] - block_len)
    active_n = torch.where(el, out[:, 7] > 0.5, a["act"])
    fc_n = torch.where(el[:, None], torch.stack([
        out[:, 0], out[:, 1] - torch.floor(out[:, 1]), out[:, 2],
        out[:, 3], out[:, 5], out[:, 6], out[:, 11]], dim=1), fc)
    return tuple(x.numpy() for x in (
        active_n.to(torch.float32), offset_n.to(torch.int32),
        epochs_n.to(torch.int32), ci_n.to(torch.int32), cf_n, fc_n))


def held_rates(prog: dict, wire: str, k: int, prev: dict | None,
               led_cols: np.ndarray | None) -> np.ndarray:
    """[U, C, 2] the carrier frequency and code rate the program held in
    each superstep of a block (its telemetry ``prog``; ``prev`` the block
    before in the span, or the span's first ledger columns)."""
    cf = np.asarray(prog["carr_freq"], np.float32)
    cr = np.asarray(prog["code_rate"], np.float32)
    u = cf.shape[0] // k
    if wire == "slim2":
        return np.stack([cf[::k], cr[::k]], axis=-1)[:u]
    if wire != "f32":
        raise ValueError(f"no span check for the {wire!r} wire")
    out = np.empty((u, cf.shape[1], 2), np.float32)
    if prev is not None:
        out[0, :, 0] = np.asarray(prev["carr_freq"], np.float32)[-1]
        out[0, :, 1] = np.asarray(prev["code_rate"], np.float32)[-1]
    else:
        out[0] = led_cols[:, [0, 3]]
    out[1:, :, 0] = cf[k - 1:-1:k][:u - 1]
    out[1:, :, 1] = cr[k - 1:-1:k][:u - 1]
    return out


def track_block(ref, g, table: torch.Tensor, led: tuple,
                prn_idx, b: int, stream_re: torch.Tensor,
                stream_im: torch.Tensor, fs: float, block_len: int,
                code_len: int, rnd=None, held: np.ndarray | None = None,
                prev_proc: np.ndarray | None = None
                ) -> tuple[dict, tuple, np.ndarray, float]:
    """Block ``b`` of a span (mxu layout) over the span stream from the
    ledger ``led``: (its telemetry {field: [T, C]} as the receiver
    reports it, with ``held`` [U, C, 2] the rates each superstep ran
    at; the ledger after it; the channels its last superstep processed;
    and, where it follows the program's rates ``held``, the largest gap,
    Hz, between the rates its own loop update gave and the program's,
    over the channels processed in the superstep before and eligible in
    this one; ``prev_proc`` names those of the block before)."""
    if g.layout != "mxu":
        raise ValueError("the span reference runs the mxu layout")
    a = anchor(ref, g, led, b, block_len, fs)
    codes = table[np.maximum(np.asarray(prn_idx), 0)]
    reps = ref.build_replicas(codes, g.el_shift, g.n0, g.wp, g.n_rows,
                              a["anchor"].numpy(), a["lane_shift"].numpy())
    st = a["mat"]
    kw = {k: v for k, v in g.kw.items() if k not in ("t_epochs",
                                                      "k_epochs")}
    k = g.k_epochs
    span = ((k - 1) * g.n0 // 128) * 128 + g.wp
    lanes = torch.arange(span, dtype=torch.int64)
    rows, used, loop = [], [], 0.0
    for j in range(g.t_epochs // k):
        if held is not None and (j or b):
            own = st[:, [0, 3]].numpy().astype(np.float64)
            if prev_proc is not None:
                m = prev_proc & (st[:, 7] > 0.5).numpy()
                if m.any():
                    loop = max(loop, float(np.abs(
                        own[m] - held[j][m].astype(np.float64)).max()))
            st = st.clone()
            st[:, 0] = torch.from_numpy(np.ascontiguousarray(held[j][:, 0]))
            st[:, 3] = torch.from_numpy(np.ascontiguousarray(held[j][:, 1]))
        used.append(st[:, [0, 3]].numpy().copy())
        off = (j * k * g.n0 // 128) * 128
        idx = a["starts"][:, None] + off + lanes[None, :]
        st, tl = ref.superstep(st, j, stream_re[idx], stream_im[idx],
                               reps, k_epochs=k,
                               rnd=rnd or ref.rounding("mxu", False), **kw)
        rows.append(tl)
        prev_proc = (tl[:, :, 16] > 0.5).numpy().any(axis=0)
    tm = torch.cat(rows, dim=0)
    processed = tm[:, :, 16] > 0.5
    nxt = absorb(g, a, st, processed, block_len, code_len)
    tn = tm.numpy()
    proc = processed.numpy()
    t_idx = np.arange(g.t_epochs, dtype=np.int64)[:, None]
    offset0 = a["offset_w"].numpy().astype(np.int64)
    epochs0 = a["epochs"].numpy().astype(np.int64)
    cp0 = a["ci"].numpy().astype(np.float64) + a["cf"].numpy()
    telem = dict(
        processed=proc,
        i_e=tn[:, :, 0], q_e=tn[:, :, 1], i_p=tn[:, :, 2], q_p=tn[:, :, 3],
        i_l=tn[:, :, 4], q_l=tn[:, :, 5], power=tn[:, :, 6],
        locked=tn[:, :, 7] > 0.5, lost_event=tn[:, :, 15] > 0.5,
        pll_err=tn[:, :, 8], dll_err=tn[:, :, 9], carr_freq=tn[:, :, 10],
        code_rate=tn[:, :, 11],
        start_offset=(offset0[None, :] + t_idx * g.n0
                      + tn[:, :, 13].astype(np.int64)).astype(np.int32),
        epoch_index=(epochs0[None, :] + np.cumsum(proc, axis=0) - proc
                     ).astype(np.int32),
        chip_phase=np.mod(cp0[None, :] + tn[:, :, 14], g.code_len
                          ).astype(np.float32),
        held=np.stack(used, axis=0))
    return telem, nxt, prev_proc, loop


def bf16_round(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def on_wire(telem: dict, wire: str, k: int) -> dict:
    """``telem`` as the program's download carries it on ``wire``."""
    if wire == "f32":
        return telem
    t = dict(telem)
    stride = 2 * k
    t_len = t["i_p"].shape[0]
    for f in ("i_p", "q_p"):
        t[f] = bf16_round(t[f])
    for f in ("i_e", "q_e", "i_l", "q_l", "pll_err", "dll_err"):
        v = bf16_round(t[f][::stride])
        t[f] = np.repeat(v, stride, axis=0)[:t_len]
    held = telem["held"]
    t["carr_freq"] = np.repeat(held[:, :, 0], k, axis=0)[:t_len]
    t["code_rate"] = np.repeat(held[:, :, 1], k, axis=0)[:t_len]
    return t
