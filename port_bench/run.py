"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the checks on stderr and one JSON result
line last on stdout (see port_bench/README.md). Needs a CUDA device; exits
non-zero with no result without one, without the port beside it, or when
the process holds a module of JAX or of the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.getcwd()
# Python's bytecode cache at a fixed path inside the checkout, written even
# where the environment turns writing it off (PYTHONDONTWRITEBYTECODE): else
# every run compiles torch's sources again, most of set-up and most of its
# spread, and a cache beside the sources would be written outside the checkout
sys.pycache_prefix = os.path.join(ROOT, ".port_bench_cache", "pycache")
sys.dont_write_bytecode = False
sys.path[:0] = [HERE, ROOT]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import runner, spec

    stages = [("start", T_START), ("torch", time.perf_counter())]

    cell = spec.cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    torch.cuda.init()
    stages.append(("cuda", time.perf_counter()))
    from harness import program

    stages.append(("port", time.perf_counter()))
    built = program.build_kernels()
    stages.append(("kernels", time.perf_counter()))
    if built:
        print(f"built the kernels: {built}", file=sys.stderr)
    result, lines = runner.run_cell(cell, seed=args.seed, seconds=args.seconds,
                                    trace=bool(args.trace), device="cuda:0", stages=stages)
    return runner.emit(result, lines)


if __name__ == "__main__":
    sys.exit(main())
