"""The readings that set the limits of ``correct``, on the card:

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s>

For each seed, in one process: a run of the cell (a window of
``--seconds``), then each compared number as the program reads it
(its lower reading), the numbers the configuration does not compare
(``readings``), and as the control reads them: the reference computed
at the configuration's control precision put in the program's place
(its upper reading), through the reference module the configuration
names. One JSON line per seed on stdout.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    from gpubench.harness import checks, spec
    from gpubench.harness.cell import run_cell

    bench = spec.load_benchmark(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = run_cell(bench, args.workload, seed, args.seconds, False,
                       device=args.device, card_clock=False,
                       log=lambda m: print(m, file=sys.stderr))
        readings = {}
        ok, prog = checks.check(run, log=lambda m: print(m, file=sys.stderr),
                                readings=readings)
        acq, acq_hz, _ = checks.check_acq(
            run, int(run.traffic["check"]["acq_searches"]), control=True)
        trk, loop, truth, _ = checks.check_tracking(run, control=True)
        line = dict(seed=seed, program={k: v for k, (v, _) in prog.items()},
                    readings=readings,
                    control=dict(acq_gap=acq, acq_freq_gap_hz=acq_hz,
                                 track_gap=trk, loop_gap_hz=loop,
                                 carrier_truth_hz=truth),
                    correct=ok, seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        del run
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
