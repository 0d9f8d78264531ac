"""Kernel B1 (the mxu layout: K-epoch supersteps, the window's carrier
mix in f32 and a bf16 contraction against R replica rows), one launch:
each stream sample that an active channel's superstep window covers
read once (re and im f32; the windows overlap, so their union), the
active channels' replica rows, the starts and the state read, and the
telemetry and state written; the operations of the lanes inside each
processed epoch's mask: 12 f32 operations of the mix and 2 x 2 x R bf16
operations (re and im rows, multiply and add). In the lean telemetry
mode of the multi-block scan the lanes come from the held rates."""
import torch

TARGET = ("gnss_sdr_tpu_torch.ops.cuda.track_block_fused",
          "track_block_fused_mxu")
MIX_OPS_PER_LANE = 12
FAR = 2 ** 62                      # a start past every window


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def window_lanes(starts, active, t_epochs, k_epochs, n0, wp):
    """Stream samples in the union of the active channels' superstep
    windows [start + off_j, + span) (computed on the starts' device)."""
    span = ((k_epochs - 1) * n0 // 128) * 128 + wp
    offs = torch.tensor([(j * k_epochs * n0 // 128) * 128
                         for j in range(t_epochs // k_epochs)],
                        dtype=torch.int64, device=starts.device)
    a = starts.to(torch.int64)[:, None] + offs[None, :]
    a = torch.where(active[:, None], a, torch.full_like(a, FAR))
    a = torch.cat([a.reshape(-1), a.new_full((1,), FAR)]).sort().values
    # each window adds what it covers before the next one starts
    return torch.clamp(a[1:] - a[:-1], max=span).sum()


def lanes_lean(telem, kw):
    """The lanes inside the processed epochs' masks from the lean
    telemetry (the multi-block scan's): the processed flag in bit 0 of
    col 16, each epoch's n_t from the rate its superstep held (col 18,
    on the superstep's first epoch; col 17 with carrier aiding), as the
    kernel rounds it."""
    k = kw["k_epochs"]
    processed = (telem[..., 16].to(torch.int32) & 1).to(torch.float32)
    held = telem[::k]
    rate = held[..., 18]
    if kw.get("aiding_scale", 0.0):
        rate = rate + (held[..., 17] - kw.get("if_freq", 0.0)) \
            * kw["aiding_scale"]
    n_t = torch.round(kw["fs"] * kw["code_len"] / rate)
    n_t = torch.where(rate > 0, n_t, torch.zeros_like(n_t))
    n_t = n_t.repeat_interleave(k, dim=0)[:telem.shape[0]]
    return (n_t * processed).double().sum()


def cost(args, kw, out):
    stream_re, _, starts, bank, state = args[:5]
    telem, st = out
    r_rows = bank.shape[1]
    active = telem[..., 16].amax(dim=0) > 0
    if kw.get("telem_mode", "full") == "lean":
        lanes = lanes_lean(telem, kw)
    else:
        lanes = (telem[..., 12] * telem[..., 16]).double().sum()
    win = window_lanes(starts[:active.shape[0]], active, kw["t_epochs"],
                       kw["k_epochs"], kw["n0"], kw["wp"])
    rows = active.sum() * bank[0].numel() * bank.element_size()
    return dict(bytes=2.0 * stream_re.element_size() * win + rows
                + nbytes(starts, state, telem, st),
                f32_ops=MIX_OPS_PER_LANE * lanes,
                bf16_ops=2.0 * 2 * r_rows * lanes)
