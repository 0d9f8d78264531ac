"""Kernel B1's lane-chunk layout as it was before the lane clusters, kept
for timing the two in turns (chip_smoke.py phase 25, B2 phase 29).

Its source is ``tools/track_block_mxu_chunked.cu``: one block per
channel walks wp in lane chunks, each chunk's bank rows staged by TMA
every superstep and its windows mixed from global memory. ``chunk_plan``
is the chunk width its launcher was given; ``launcher(lib)`` adapts its
entry point to the port's wrapper (``track_block_fused.MXU_ARGTYPES``),
so ``using(fn)`` runs the wrapper's launches on it. Needs nvcc and a
card; nothing here runs at import time.
"""
from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "track_block_mxu_chunked.cu"
NAME = "track_block_mxu_chunked"


def chunk_plan(wp: int, r_rows: int, k_epochs: int,
               smem: int = 232_448) -> dict:
    """The chunk width the old launcher took: the widest 128-multiple
    whose two bank buffers [R, chunk] and tile [2K, chunk] (bf16, rows
    padded by 8) fit beside the trig factors [2, K, wp/128] f32 and 28 KB
    of static arrays, evened out over the chunks. Returns {"chunk",
    "chunks", "max_wp"}; raises ValueError above "max_wp"."""
    w128, pad = wp // 128, 8
    trig = 2 * k_epochs * w128 * 4
    room = smem - 28_672
    per_chunk = (2 * r_rows + 2 * k_epochs) * (128 + pad) * 2
    max_wp = max(0, (room - per_chunk) // (8 * k_epochs)) * 128

    def chunk_bytes(width):
        return (2 * r_rows + 2 * k_epochs) * (width + pad) * 2 + trig

    widest = 0
    while widest + 128 <= wp and chunk_bytes(widest + 128) <= room:
        widest += 128
    if widest == 0:
        raise ValueError(f"wp={wp} above the old chunks' {max_wp}")
    n = -(-w128 // (widest // 128))
    chunk = -(-w128 // n) * 128
    return {"chunk": chunk, "max_wp": max_wp,
            "chunks": [(l0, min(chunk, wp - l0))
                       for l0 in range(0, wp, chunk)]}


def old_layout(wp: int, r_rows: int, k_epochs: int,
               smem: int = 232_448) -> str:
    """The layout the plan chose before the lane clusters: "whole"
    while the bank [R, wp] and tile [2K, wp] fit beside the trig factors
    and 28 KB of static arrays and R <= 16, else "chunked"."""
    whole = ((r_rows + 2 * k_epochs) * (wp + 8) * 2
             + 2 * k_epochs * (wp // 128) * 4)
    return ("whole" if whole <= smem - 28_672 and r_rows <= 16
            else "chunked")


def load():
    """The old source built with the port's flags (cached as the port's
    own builds are), its entry point typed as its launcher was."""
    from gnss_sdr_tpu_torch.ops.cuda import _build
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    fn = _build.load_library(NAME, SOURCE).track_block_mxu_launch
    # the same parameters up to the stream, then the chunk width
    fn.argtypes, fn.restype = fused.MXU_ARGTYPES[:-2], ctypes.c_int
    return fn


def launcher(fn):
    """A function with the current launcher's parameters that runs the
    old kernel: in lane chunks of ``chunk_plan``'s width where the
    wrapper's plan is the lane clusters, whole width elsewhere."""
    def run(*args):
        *head, cluster, stream, lanes, _staged, _warps = args
        chunk = 0
        if lanes:
            wp, r_rows, k_epochs = args[12], args[13], args[10]
            chunk = chunk_plan(wp, r_rows, k_epochs)["chunk"]
        return fn(*head, cluster if not lanes else 1, stream, chunk)
    return run


@contextlib.contextmanager
def using(fn):
    """The port's mxu wrapper launches ``fn`` (a function with the
    current launcher's parameters) while the context is open."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    lib = fused._lib
    fused._lib = lambda: fn  # noqa: E731
    try:
        yield
    finally:
        fused._lib = lib
