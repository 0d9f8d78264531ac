"""Kernel B5 (the scanned tracker's E/P/L correlator, one epoch), one
launch: every input read once and the [C, 6] sums written once; 24 f32
operations of each lane inside the epoch's mask."""
TARGET = ("gnss_sdr_tpu_torch.ops.cuda.epl_correlator",
          "epl_correlate_pallas")
OPS_PER_LANE = 24


def cost(args, kw, out):
    re, n_valid = args[0], args[2]
    n_bytes = sum(x.numel() * x.element_size() for x in args
                  if hasattr(x, "numel")) + re.shape[0] * 6 * 4
    lanes = n_valid.clamp(0, re.shape[1]).double().sum()
    return dict(bytes=float(n_bytes), f32_ops=OPS_PER_LANE * lanes,
                bf16_ops=0.0)
