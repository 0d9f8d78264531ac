#!/usr/bin/env python3
"""The consumer wait of the JAX package's streaming ingest, as
``tests/test_streaming_ingest.py::TestOverlapProof::test_feeder_stays_ahead_of_slow_consumer``
measures it (40 reads of 1000 samples, 2 ms of consumer work after
each, a depth-3 feeder; the test asserts ``consumer_wait_s < 0.010``),
repeated, so that its spread can be read alone and beside a load:

    JAX_PLATFORMS=cpu python tools/overlap_wait_probe.py 20
    # beside the port's CPU tests on 6 workers, in another shell:
    python -m pytest tests/test_torch_*.py -q -p xdist -n 6 --dist loadfile

Prints one JSON line: each run's consumer_wait_s, the largest, and how
many passed the test's 10 ms. Runs on the CPU.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from gnss_sdr_tpu.receiver import ArraySource, StreamingDeviceSource  # noqa: E402
import numpy as np  # noqa: E402


def _sig(n, seed=0):
    # the test's signal: complex64 noise
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def main() -> int:
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    waits = []
    for _ in range(runs):
        src = StreamingDeviceSource(ArraySource(_sig(40 * 1000), 1e6),
                                    depth=3, store="f32")
        try:
            for _ in range(40):
                src.read(1000)
                time.sleep(0.002)
            waits.append(src.stats()["consumer_wait_s"])
        finally:
            src.close()
    print(json.dumps({"consumer_wait_s": waits, "max": max(waits),
                      "under_10ms": sum(w < 0.010 for w in waits),
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
