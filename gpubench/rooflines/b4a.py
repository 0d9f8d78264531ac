"""Kernel B4a (the per-epoch core on the windows feed), one launch:
counted as B4b (rooflines/b4b.py)."""
import importlib.util
from pathlib import Path

TARGET = ("gnss_sdr_tpu_torch.ops.cuda.track_block_fused",
          "track_block_fused")

_spec = importlib.util.spec_from_file_location(
    "gpubench_roofline_b4b", Path(__file__).with_name("b4b.py"))
_b4b = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_b4b)


def cost(args, kw, out):
    return _b4b.cost(args, kw, out)
