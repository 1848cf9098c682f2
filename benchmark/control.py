"""Readings that the limits of a cell's check are set from, on the card:

    python3 benchmark/control.py --workload <cell> --seeds <n> ... [--control 3] [--requests 4]

For each seed, the cell's set-up (the seed's weights and traffic), `--requests`
requests of its traffic, then the numbers its check compares: the system's
against the float32 reference, and for the first `--control` seeds also the
control's, the reference computed with its products in float8 (e4m3) in the
system's place. One JSON line per seed on standard output."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark import core

    c = core.resolve(core.spec(), args.workload)
    for j, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        st = c.driver.setup(c.config, c.mix, seed, args.device)
        for i in range(args.requests):
            inp = c.driver.make_input(st, i)
            out, _ = c.driver.call(st, inp, False)
            c.driver.keep(st, i, inp, out)
        c.driver.release(st)
        row = {"seed": seed, "system": c.driver.readings(st)}
        if j < args.control:
            row["control"] = c.driver.readings(st, quant=torch.float8_e4m3fn)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del st
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
