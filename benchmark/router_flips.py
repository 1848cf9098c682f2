"""How the system's routing and the float32 reference's part, on the card, for the cell
recon-32v-kimivl:

    python3 benchmark/router_flips.py --seeds <n> ... [--control 1] [--requests 2]
        [--balance-steps 200] [--tie 0.015625]

For each seed, the cell's set-up (`--balance-steps 0` leaves the drawn router biases as they are;
`--tie` sets reference/kimivl.py's TIE), `--requests` calls of its traffic and the release of
drivers/recon_kimivl.py, which records the system's choices of the kept calls. Then the reference
runs each kept call following them at near ties, and the line gives the check's relative errors
(`system`; and for the first `--control` seeds the fp8 control's, `control`) and for each MoE layer,
the largest over the kept calls of: `differ`, the share of rows whose k experts in the system differ
from the reference's own top k; `beyond`, the share of rows that differ by a choice further than TIE
below the reference's k-th biased score (those the reference does not follow); `deficit_q99`,
`deficit_max`, the 99th percentile and the largest, over the rows that differ, of the reference's
k-th biased score less the lowest of the system's k in the reference's scores. One JSON line per seed."""

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
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--balance-steps", type=int, default=None)
    ap.add_argument("--tie", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark import core, weights
    from benchmark.reference import kimivl

    c = core.resolve(core.spec(), "recon-32v-kimivl")
    drv, cfg, k = c.driver, c.config, c.config["num_experts_per_tok"]
    if args.balance_steps is not None:
        drv.BALANCE_STEPS = args.balance_steps
    if args.tie is not None:
        kimivl.TIE = args.tie
    for j, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        st = drv.setup(cfg, c.mix, seed, args.device)
        for i in range(args.requests):
            inp = drv.make_input(st, i)
            out, _ = drv.call(st, inp, False)
            drv.keep(st, i, inp, out)
        drv.release(st)
        W = {}
        for part in weights.chunks(kimivl.param_shapes(cfg), seed, args.device, drv.DTYPES[cfg["dtype"]]):
            W.update((n, v) for n, v in part.items() if not n.startswith(("vit_model.", "language_model.lm_head")))
        W = kimivl.Fp32(dict(W, **st.bias))
        err = {n: 0.0 for n in drv.OUTPUTS}
        layers = {n: [] for n in ("differ", "beyond", "deficit_q99", "deficit_max")}
        with torch.no_grad():
            for (i, out), chosen in zip(st.kept, st.routes):
                record = []
                want = kimivl.recon(W, cfg, torch.as_tensor(drv.make_input(st, i), device=args.device),
                                    c.mix["new_width"], follow=chosen, record=record)
                for n in drv.OUTPUTS:
                    got = torch.as_tensor(out[n], device=args.device).float()
                    e = (torch.linalg.vector_norm(got - want[n]) / torch.linalg.vector_norm(want[n])).item()
                    err[n] = max(err[n], e)
                for layer, ((biased, _), f) in enumerate(zip(record, chosen)):
                    f = f[:biased.shape[0]].long()
                    kth = torch.topk(biased, k, -1).values[:, -1]
                    own = torch.topk(biased, k, -1).indices
                    differ = (f.sort(-1).values != own.sort(-1).values).any(-1)
                    deficit = (kth - biased.gather(1, f).min(-1).values)[differ]
                    row = [differ.float().mean().item(), (deficit > kimivl.TIE).float().sum().item() / len(f),
                           deficit.quantile(0.99).item() if len(deficit) else 0.0,
                           deficit.max().item() if len(deficit) else 0.0]
                    for n, v in zip(layers, row):
                        if len(layers[n]) <= layer:
                            layers[n].append(v)
                        layers[n][layer] = max(layers[n][layer], v)
                del record, want
        del W
        line = {"seed": seed, "balance_steps": drv.BALANCE_STEPS, "tie": kimivl.TIE,
                "system": {f"{n}_rel_err": v for n, v in err.items()}}
        line.update({n: [float("%.4g" % v) for v in vs] for n, vs in layers.items()})
        if j < args.control:
            line["control"] = drv.readings(st, quant=torch.float8_e4m3fn)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del st
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
