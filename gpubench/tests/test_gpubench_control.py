"""The control at a size a test run holds: on the CPU, a short run of
each configuration reads within its limits, and the reference at the
control's precision put in the program's place (bfloat16 for the
scanned tracker and the searches, float8 mxu operands and bfloat16 seg
operands for the fused tracker) fails at least one of them."""
import pytest

from gpubench.harness import checks, spec
from gpubench.harness.cell import run_cell

BENCH = spec.load_benchmark()


@pytest.mark.parametrize("cell,seconds", [("rtlsdr.open_sky", 0.6),
                                          ("ladder4.sparse_sky", 0.3)])
def test_control_fails_a_limit(cell, seconds):
    run = run_cell(BENCH, cell, 20261018, seconds, False, device="cpu",
                   log=lambda m: None)
    chk = run.traffic["check"]
    ok, prog = checks.check(run, log=lambda m: None)
    assert ok, prog
    limits = run.config["limits"]
    acq, acq_hz, _ = checks.check_acq(run, int(chk["acq_searches"]),
                                      control=True)
    trk, loop, truth, _ = checks.check_track(run, int(chk["track_blocks"]),
                                      control=True)
    control = dict(acq_gap=acq, acq_freq_gap_hz=acq_hz, track_gap=trk,
                   loop_gap_hz=loop, carrier_truth_hz=truth)
    assert any(v > limits[k] for k, v in control.items() if k in limits), \
        control
