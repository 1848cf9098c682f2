"""Times the forward kernels (K1 batched and K6 its lse form, K2 segment
attention) of two checkouts of this repository against each other on one
NVIDIA GPU, in turns, so that a change to the kernel sources can be held
against its parent on the same card:

    python g2vlm_tpu_torch/tools/time_forward_kernels.py PARENT_ROOT CHANGE_ROOT

Each root is a directory that holds a `g2vlm_tpu_torch` package (for example
`git archive <commit>` unpacked somewhere, and `.` for the working tree). Each
tree is imported in its own subprocess, which builds its kernels and prints
one JSON line of times; the order is parent, change, change, parent. Shapes:
K1 at the DINOv2-L and Pi3 recon batches (32, 782, 16, 64) and (32, 777, 16,
96), K6 at the training batches (16, 782, 16, 64) and (16, 777, 16, 96), K2 at
the 32-view recon prefill. K2's outputs must be bitwise equal in both trees;
K1's and K6's are held against each other within chip_smoke.py's forward
limits (the two trees may round differently), and each tree's two launches
must agree bitwise.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

# chip_smoke.py's limits of a forward against its reference: outputs are O(1)
FWD_MAX_ABS, FWD_MEAN_ABS = 2e-2, 1e-3
LSE_MAX_ABS = 2e-3

_WORKER = r"""
import hashlib, json, sys
import torch
sys.path.insert(0, sys.argv[1])
from g2vlm_tpu_torch.models.g2vlm import SequenceBuilder
from g2vlm_tpu_torch.ops import flash_attention as fa

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
out, saved, bitwise = {}, {}, True
for tag, b, s, h, d, lse in (("k1_dinov2_32x782x16x64", 32, 782, 16, 64, False),
                             ("k1_pi3_32x777x16x96", 32, 777, 16, 96, False),
                             ("k6_dinov2_16x782x16x64", 16, 782, 16, 64, True),
                             ("k6_pi3_16x777x16x96", 16, 777, 16, 96, True)):
    q, k, v = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)
    run = lambda: fa._batched_forward_cuda(q, k, v, None, None, with_lse=lse)
    first, second = run(), run()
    bitwise &= all(x is None or torch.equal(x, y) for x, y in zip(first, second))
    saved[tag] = [x.cpu() for x in first if x is not None]
    out[tag] = [time_ms(run, 50) for _ in range(3)]
sb = SequenceBuilder(11, 12)
sb.add_text([7, 1, 2, 3, 4])
sb.add_dino_images(32, 21, 37)
info = sb.build(pad_to=-(-sb.curr // 256) * 256).token_info("cuda")
n = info.seq_len
q, k, v = rnd(n, 12, 128), rnd(n, 2, 128), rnd(n, 2, 128)
out["k2_outputs_sha256"] = hashlib.sha256(
    fa.flash_segment_attention(q, k, v, info, info).float().cpu().numpy().tobytes()).hexdigest()
out["k2_prefill_25088x12:2x128"] = [time_ms(lambda: fa.flash_segment_attention(q, k, v, info, info), 5)
                                    for _ in range(3)]
out["bitwise_repeatable"] = bitwise
if len(sys.argv) > 2:
    torch.save(saved, sys.argv[2])
print(json.dumps(out))
"""


def main() -> None:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    parent, change = sys.argv[1:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    scratch = Path(__file__).resolve().parent.parent / "_build" / "time_forward"
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
        if len({r["k2_outputs_sha256"] for _, r in runs}) != 1:
            raise SystemExit("the two trees' K2 outputs differ")
        print("K2: the outputs of both trees are bitwise equal")
        want, got = torch.load(saved["parent"]), torch.load(saved["change"])
        for tag in want:
            for name, g, w in zip(("out", "lse"), got[tag], want[tag]):
                err = (g.float() - w.float()).abs()
                print(f"{tag} {name}: change against parent max_abs_err {err.max().item():.3e} "
                      f"mean_abs_err {err.mean().item():.3e}")
                limits = (FWD_MAX_ABS, FWD_MEAN_ABS) if name == "out" else (LSE_MAX_ABS, LSE_MAX_ABS)
                if err.max().item() > limits[0] or err.mean().item() > limits[1]:
                    raise SystemExit(f"{tag} {name}: the trees disagree (limits {limits})")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for key in runs[0][1]:
        if key in ("k2_outputs_sha256", "bitwise_repeatable"):
            continue
        med = {}
        for label in ("parent", "change"):
            xs = sorted(t for lab, r in runs if lab == label for t in r[key])
            med[label] = xs[len(xs) // 2]
        print(f"{key}: parent {med['parent']:.4f} ms, change {med['change']:.4f} ms "
              f"({(med['change'] / med['parent'] - 1) * 100:+.1f}%) ({card})")


if __name__ == "__main__":
    main()
