"""Kernel B4c (the segment gather), one launch: the block's stream and
the starts read once and the [C, Lseg] segments written once; no
arithmetic."""
TARGET = ("gnss_sdr_tpu_torch.ops.cuda.track_block_fused",
          "gather_segments")


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def cost(args, kw, out):
    return dict(bytes=float(nbytes(*args[:3], *out)), f32_ops=0.0,
                bf16_ops=0.0)
