"""Times the backward kernels (K5 segment and K7 batched, dq and dkv apart) of
two checkouts of this repository against each other on one NVIDIA GPU, so that
a change to csrc/attention_bwd.cu can be held against its parent on the same
card:

    python g2vlm_tpu_torch/tools/time_backward_kernels.py PARENT_ROOT CHANGE_ROOT

Each root is a directory that holds a `g2vlm_tpu_torch` package and
`train_torch.py` (for example `git archive <commit>` unpacked somewhere, and
`.` for the working tree). Each tree is imported in its own subprocess, which
builds its kernels and prints one JSON line of times; the order is parent,
change, change, parent. Shapes: K5 at the 16-view training pack (12,800 rows,
12:2 heads of 128, its own TokenInfo; out and lse from the plain forward, so
that both trees' K5 read the same inputs), K7 at (16, 782, 16, 64) and (16,
777, 16, 96) on the tree's own K6. The two trees' dq, dk and dv are held
against each other within chip_smoke.py's backward limits (the order of the
sums may differ) and reported as bitwise equal or not, and each tree's two
launches must agree bitwise.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

# chip_smoke.py's limits of a backward against its reference: max |err| / max |ref|, mean |err| / mean |ref|
BWD_MAX_REL, BWD_MEAN_REL = 2e-2, 5e-3

_WORKER = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import train_torch
from g2vlm_tpu_torch.config import G2VLMConfig
from g2vlm_tpu_torch.ops import flash_attention as fa
from g2vlm_tpu_torch.ops.masks import TokenInfo

def time_ms(fn, iters):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters

gen = torch.Generator(device="cuda").manual_seed(0)
rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
out, grads, bitwise = {}, {}, True
batch, _ = train_torch.full_size_batch(G2VLMConfig(visual_und=False), 16, (294, 518), 12800, 0, "cuda")
one = batch.map(lambda x: x[0])
info = TokenInfo(one.doc_id, one.fn_id, one.noise_id, one.pos)
n = info.seq_len
q, k, v, do = rnd(n, 12, 128), rnd(n, 2, 128), rnd(n, 2, 128), rnd(n, 12, 128)
meta = info.packed()
codes = fa.block_codes(meta, meta)
# out and lse of the plain forward, the same in both trees whatever their forward kernels
o, lse = fa.flash_segment_attention_lse_reference(q.float(), k.float(), v.float(), info, info)
o, lse = o.to(torch.bfloat16).contiguous(), lse.contiguous()
run = lambda which: fa._segment_backward_cuda(q, k, v, o, lse, do, meta, meta, codes, None, which=which)
tag = "k5_12800x12:2x128"
first, second = run(("dq", "dkv")), run(("dq", "dkv"))
bitwise &= all(torch.equal(x, y) for x, y in zip(first, second))
grads[tag] = [t.cpu() for t in first]
out[tag + "_dq"] = [time_ms(lambda: run(("dq",)), 5) for _ in range(3)]
out[tag + "_dkv"] = [time_ms(lambda: run(("dkv",)), 5) for _ in range(3)]
for b, s, h, d in ((16, 782, 16, 64), (16, 777, 16, 96)):
    q, k, v, do = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)
    o, lse = fa._batched_forward_cuda(q, k, v, None, None, with_lse=True)
    run = lambda which: fa._batched_backward_cuda(q, k, v, o, lse, do, None, None, which=which)
    tag = f"k7_{b}x{s}x{h}x{d}"
    first, second = run(("dq", "dkv")), run(("dq", "dkv"))
    bitwise &= all(torch.equal(x, y) for x, y in zip(first, second))
    grads[tag] = [t.cpu() for t in first]
    out[tag + "_dq"] = [time_ms(lambda: run(("dq",)), 20) for _ in range(3)]
    out[tag + "_dkv"] = [time_ms(lambda: run(("dkv",)), 20) for _ in range(3)]
out["bitwise_repeatable"] = bitwise
if len(sys.argv) > 2:
    torch.save(grads, sys.argv[2])
print(json.dumps(out))
"""


def _rel(got: torch.Tensor, want: torch.Tensor):
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    return (err.max() / ref.max()).item(), (err.mean() / ref.mean()).item()


def main() -> None:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    parent, change = sys.argv[1:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    scratch = Path(__file__).resolve().parent.parent / "_build" / "time_backward"
    scratch.mkdir(parents=True, exist_ok=True)
    saved = {"parent": scratch / "parent.pt", "change": scratch / "change.pt"}
    runs = []
    try:
        for label, root in (("parent", parent), ("change", change), ("change", change), ("parent", parent)):
            cmd = [sys.executable, "-c", _WORKER, root]
            if not saved[label].exists():
                cmd.append(str(saved[label]))
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise SystemExit(f"{label} ({root}) failed:\n{proc.stderr[-3000:]}")
            result = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append((label, result))
            print(f"[{label}] {json.dumps(result)} ({card})", flush=True)
        if not all(r["bitwise_repeatable"] for _, r in runs):
            raise SystemExit("a tree's two launches gave different results")
        want, got = torch.load(saved["parent"]), torch.load(saved["change"])
        for tag in want:
            for name, g, w in zip(("dq", "dk", "dv"), got[tag], want[tag]):
                max_rel, mean_rel = _rel(g, w)
                print(f"{tag} {name}: change against parent {'bitwise equal' if torch.equal(g, w) else 'differs'}, "
                      f"max|err|/max|ref| {max_rel:.3e} mean|err|/mean|ref| {mean_rel:.3e}")
                if max_rel > BWD_MAX_REL or mean_rel > BWD_MEAN_REL:
                    raise SystemExit(f"{tag} {name}: the trees disagree (limits {BWD_MAX_REL}, {BWD_MEAN_REL})")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for key in runs[0][1]:
        if key == "bitwise_repeatable":
            continue
        med = {}
        for label in ("parent", "change"):
            xs = sorted(t for lab, r in runs if lab == label for t in r[key])
            med[label] = xs[len(xs) // 2]
        print(f"{key}: parent {med['parent']:.4f} ms, change {med['change']:.4f} ms "
              f"({(med['change'] / med['parent'] - 1) * 100:+.1f}%) ({card})")


if __name__ == "__main__":
    main()
