"""Run one cell of the benchmark of g2vlm_tpu_torch once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights drawn from the seed on the card, the traffic's inputs, one
warm-up of each shape the traffic uses) runs first and counts as set-up;
then the cell's traffic runs for `--seconds`, and the outputs are checked
against the plain reference under benchmark/reference/. The last line of
standard output is one JSON object: correct, attempted, failed, metrics,
device (and with --trace 1 the breakdown of the profiled sub-window), and
last the checks, each number compared beside its limit. Without the cards
the cell asks for, or with jax, jaxlib, flax, optax or g2vlm_tpu loaded once
the window has closed, it prints no result and exits non-zero.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel build caches stay inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_JAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import core

    torch.set_num_threads(4)
    try:
        out = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    except core.NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = core.forbidden_modules()
    if found:
        print(f"benchmark: modules loaded that the port's runs may not load: {', '.join(found)}", file=sys.stderr)
        return 3
    core.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
