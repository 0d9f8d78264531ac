"""Run one cell of the benchmark of the PyTorch/CUDA port once:

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` beside ``gpubench/``).
The last line of stdout is the result's JSON object; the last lines of
stderr are the numbers compared with the reference, each beside its
limit. It exits non-zero, printing no result, without a CUDA card (or
fewer than the cell asks for), without the port beside it, or where JAX
or the JAX package was loaded into this process.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".gpubench_cache"


def _environment() -> None:
    # every build and kernel cache inside the checkout, at fixed paths
    # (the port's own nvcc builds go to gnss_sdr_tpu_torch/_build/)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")
    # PyTorch makes the last directory of its kernel cache's path only
    (CACHE / "torch_kernels").mkdir(parents=True, exist_ok=True)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # load from one process with few threads: the host's share of the
    # work is serial, and other threads only contend with it
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    from gpubench.harness import entry, spec

    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    try:
        import gnss_sdr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port is not beside the benchmark: {e}", file=sys.stderr)
        return 4
    result = entry.execute(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda",
                           t_process=T_PROCESS)
    return 0 if result is not None else 5


if __name__ == "__main__":
    sys.exit(main())
