"""Kernel B4b (the per-epoch core on the seg feed), one launch: the
lanes inside each processed epoch's mask once (re and im f32: each
channel has its own window), the active channels' replica rows, the
state in and out and the telemetry; 24 f32 operations a lane."""
TARGET = ("gnss_sdr_tpu_torch.ops.cuda.track_block_fused",
          "track_block_fused_seg")
OPS_PER_LANE = 24


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def epoch_bytes(own_windows: bool, args, telem, st):
    lanes = (telem[..., 12] * telem[..., 16]).double().sum()
    reps = args[2]
    active = (telem[..., 16].amax(dim=0) > 0).sum()
    win = 8.0 * lanes if own_windows else nbytes(*args[:2])
    return (win + active * reps[0].numel() * reps.element_size()
            + nbytes(args[3], telem, st)), lanes


def cost(args, kw, out):
    telem, st = out
    n_bytes, lanes = epoch_bytes(True, args, telem, st)
    return dict(bytes=n_bytes, f32_ops=OPS_PER_LANE * lanes, bf16_ops=0.0)
