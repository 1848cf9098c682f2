"""Times the two no-grad forward kernels (K1 batched, K2 segment attention) of
two checkouts of this repository against each other on one NVIDIA GPU, in
turns inside one process, so that a change to the kernel sources can be held
against its parent on the same card:

    python g2vlm_tpu_torch/tools/time_forward_kernels.py PARENT_ROOT CHANGE_ROOT

Each root is a directory that holds a `g2vlm_tpu_torch` package (for example
`git archive <commit>` unpacked somewhere, and `.` for the working tree). Each
tree is imported in its own subprocess, which builds its kernels and prints
one JSON line of times; the order is parent, change, change, parent. Also
checks that the two trees' outputs are bitwise equal.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys

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
out = {}
digest = hashlib.sha256()
for tag, b, s, h, d in (("k1_dinov2_32x782x16x64", 32, 782, 16, 64), ("k1_pi3_32x777x16x96", 32, 777, 16, 96)):
    q, k, v = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)
    digest.update(fa.flash_batched_attention(q, k, v).float().cpu().numpy().tobytes())
    out[tag] = [time_ms(lambda: fa.flash_batched_attention(q, k, v), 50) for _ in range(3)]
sb = SequenceBuilder(11, 12)
sb.add_text([7, 1, 2, 3, 4])
sb.add_dino_images(32, 21, 37)
info = sb.build(pad_to=-(-sb.curr // 256) * 256).token_info("cuda")
n = info.seq_len
q, k, v = rnd(n, 12, 128), rnd(n, 2, 128), rnd(n, 2, 128)
digest.update(fa.flash_segment_attention(q, k, v, info, info).float().cpu().numpy().tobytes())
out["k2_prefill_25088x12:2x128"] = [time_ms(lambda: fa.flash_segment_attention(q, k, v, info, info), 5) for _ in range(3)]
out["outputs_sha256"] = digest.hexdigest()
print(json.dumps(out))
"""


def main() -> None:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    parent, change = sys.argv[1:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runs = []
    for label, root in (("parent", parent), ("change", change), ("change", change), ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", _WORKER, root], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{label} ({root}) failed:\n{proc.stderr[-3000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append((label, result))
        print(f"[{label}] {json.dumps(result)} ({card})")
    if len({r["outputs_sha256"] for _, r in runs}) != 1:
        raise SystemExit("the two trees' kernel outputs differ")
    print("outputs of both trees are bitwise equal")
    for key in runs[0][1]:
        if key == "outputs_sha256":
            continue
        med = {}
        for label in ("parent", "change"):
            xs = sorted(t for lab, r in runs if lab == label for t in r[key])
            med[label] = xs[len(xs) // 2]
        print(f"{key}: parent {med['parent']:.4f} ms, change {med['change']:.4f} ms "
              f"({(med['change'] / med['parent'] - 1) * 100:+.1f}%) ({card})")


if __name__ == "__main__":
    main()
