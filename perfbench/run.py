"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload serve_mono-surs_bf16 --seed 7 \
        --seconds 30 --trace 0

``setup_s`` runs from this process's start to the window's. Without a
card, or with fewer cards than the cell asks for, it fails and prints no
result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host's math libraries keep to two,
# so a run's host work does not spread over a shared machine's cores
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench import harness
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    import torch
    chips = next((w.get("chips", 1) for w in bench["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no card: the cell needs {chips} CUDA device(s), "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    run = harness.prepare(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), T0, "cuda")
    harness.drive(run)
    return harness.print_result(harness.result(bench, run))


if __name__ == "__main__":
    sys.exit(main())
