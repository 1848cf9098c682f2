"""Times the forward kernels (K1 batched and K6 its lse form; K2 segment
attention, K3 its lse form, K4 its two-stage schedule and K8 its int8-QK form)
of two checkouts of
this repository against each other on one NVIDIA GPU, in turns, so that a
change to the kernel sources can be held against its parent on the same card:

    python g2vlm_tpu_torch/tools/time_forward_kernels.py PARENT_ROOT CHANGE_ROOT

Each root is a directory that holds a `g2vlm_tpu_torch` package (for example
`git archive <commit>` unpacked somewhere, and `.` for the working tree). Each
tree is imported in its own subprocess, which builds its kernels and prints
one JSON line of times; the order is parent, change, change, parent. Shapes:
K1 at the DINOv2-L and Pi3 recon batches (32, 782, 16, 64) and (32, 777, 16,
96), K6 at the training batches (16, 782, 16, 64) and (16, 777, 16, 96); K2 at
the 32-view recon prefill (25,088 rows, 12:2 heads of 128), at the 32-view
chat prefill in the sorted SPLIT layout (48,384 rows) and at one ViT chunk
(11,664 rows, 16:16 heads of 80); K2 on the first query shard of the recon
prefill sequence-parallel over n = 2 and 4 ranks (S / n query rows against
all S keys); K3 at the 16-view training pack (12,800 rows); K4 at the chat
prefill; K8 at the chat prefill and the ViT chunk, on the quantised operands
and with the quantiser (`quantize_qk`) in the time ("k8q"). The two trees'
outputs are held against each other within chip_smoke.py's forward limits
(the trees may round differently) and reported as bitwise equal or not; the
kernels whose schedule `BITWISE` names (K4, K8 and K2 at head dim 80) must be
bitwise equal in both trees, and each tree's two launches must agree
bitwise. Each tree's first run prints ptxas's registers and spills of the
segment forwards at head dim 128, where its build compiled them. The times
are printed either way, and the script exits non-zero after them if a check
failed (a probe tree that computes something else on purpose fails them).
The segment kernels are timed with the caller's plan, as the main path runs
them.
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
# tags of the kernels that a change to K2 / K3's schedule at head dim 128 must leave bitwise as they were
BITWISE = ("k4_", "k8_", "k8q_", "k2_vit_")

_WORKER = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from g2vlm_tpu_torch.config import G2VLMConfig
from g2vlm_tpu_torch.data.device_preprocess import vit_device_grid
from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
from g2vlm_tpu_torch.models.g2vlm import SequenceBuilder, split_order
from g2vlm_tpu_torch.ops import flash_attention as fa
from g2vlm_tpu_torch.ops.masks import TokenInfo

_, log = fa.build_library()  # empty where the tree's build was there already
entry = ""
for line in log.splitlines():
    if "Compiling entry" in line:
        entry = line
    if ("registers" in line or "spill" in line) and "segment_fwd_kernel" in entry and "Li128E" in entry:
        print("[ptxas]", entry.split("'")[1] if "'" in entry else entry, line.strip())

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

def measure(tag, run, iters):
    global bitwise
    first, second = run(), run()
    first, second = (first, second) if isinstance(first, tuple) else ((first,), (second,))
    bitwise &= all(torch.equal(x, y) for x, y in zip(first, second))
    saved[tag] = [x.cpu() for x in first]
    del first, second
    out[tag] = [time_ms(run, iters) for _ in range(3)]

for tag, b, s, h, d, lse in (("k1_dinov2_32x782x16x64", 32, 782, 16, 64, False),
                             ("k1_pi3_32x777x16x96", 32, 777, 16, 96, False),
                             ("k6_dinov2_16x782x16x64", 16, 782, 16, 64, True),
                             ("k6_pi3_16x777x16x96", 16, 777, 16, 96, True)):
    q, k, v = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)
    measure(tag, lambda: tuple(x for x in fa._batched_forward_cuda(q, k, v, None, None, with_lse=lse)
                               if x is not None), 50)

def packed_info(n_views, text, pad_to):
    sb = SequenceBuilder(11, 12)
    for t in text:
        sb.add_text(t)
    sb.add_dino_images(n_views, 21, 37)
    return sb.build(pad_to=pad_to(sb.curr)).token_info("cuda")

recon = packed_info(32, [[7, 1, 2, 3, 4]], lambda n: -(-n // 256) * 256)
train = packed_info(16, [list(range(100, 107)), list(range(200, 224))], lambda n: 12800)
grid = vit_device_grid()
pre = G2VLMPipeline(None, G2VLMConfig()).build_chat_prefill(32, 21, 37, [grid] * 32,
    "The red point and the blue point mark two positions. Which one is closer to the camera?")
perm = torch.as_tensor(split_order(pre)[0], device="cuda")
chat = TokenInfo(*(f[perm] for f in pre.token_info("cuda")))
seg = torch.arange(4, device="cuda", dtype=torch.int32).repeat_interleave(int(np.prod(grid)))
vit = TokenInfo(seg, seg, torch.full_like(seg, -1), torch.arange(len(seg), device="cuda", dtype=torch.int32))
for tag, info, h, kvh, d, kind, iters in (
        ("k2_recon_prefill_25088x12:2x128", recon, 12, 2, 128, "k2", 5),
        ("k2_chat_prefill_48384x12:2x128", chat, 12, 2, 128, "k2", 3),
        ("k4_chat_prefill_48384x12:2x128", chat, 12, 2, 128, "k4", 3),
        ("k2_vit_chunk_11664x16:16x80", vit, 16, 16, 80, "k2", 10),
        ("k2_recon_shard2_12544of25088x12:2x128", recon, 12, 2, 128, "shard2", 10),
        ("k2_recon_shard4_6272of25088x12:2x128", recon, 12, 2, 128, "shard4", 20),
        ("k3_train_pack_12800x12:2x128", train, 12, 2, 128, "k3", 10),
        ("k8_chat_prefill_48384x12:2x128", chat, 12, 2, 128, "k8", 3),
        ("k8q_chat_prefill_48384x12:2x128", chat, 12, 2, 128, "k8q", 3),
        ("k8_vit_chunk_11664x16:16x80", vit, 16, 16, 80, "k8", 10),
        ("k8q_vit_chunk_11664x16:16x80", vit, 16, 16, 80, "k8q", 10)):
    n = info.seq_len
    q, k, v = rnd(n, h, d), rnd(n, kvh, d), rnd(n, kvh, d)
    plan = fa.segment_plan(info, info)
    if kind.startswith("shard"):  # rank 0 of n: its S / n query rows against all S keys
        local = info.slice(0, n // int(kind[5:]))
        q_local, plan = q[:local.seq_len], fa.segment_plan(local, info)
        run = lambda: fa.flash_segment_attention(q_local, k, v, local, info, plan=plan)
    elif kind == "k3":
        run = lambda: fa._segment_forward_cuda(q, k, v, *plan, None, with_lse=True)
    elif kind == "k8":
        q8, qs, k8, ks = fa.quantize_qk(q, k, plan.kv_meta)
        run = lambda: fa._int8_forward_cuda(q8, qs, k8, ks, v, *plan)
    elif kind == "k8q":
        run = lambda: fa.flash_segment_attention_int8(q, k, v, info, info, plan=plan)
    else:
        run = lambda: fa.flash_segment_attention(q, k, v, info, info, pipelined=kind == "k4", plan=plan)
    measure(tag, run, iters)
    del q, k, v
    torch.cuda.empty_cache()
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
    runs, failures = [], []
    try:
        for label, root in (("parent", parent), ("change", change), ("change", change), ("parent", parent)):
            cmd = [sys.executable, "-c", _WORKER, root]
            if not saved[label].exists():
                cmd.append(str(saved[label]))
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise SystemExit(f"{label} ({root}) failed:\n{proc.stderr[-3000:]}")
            lines = proc.stdout.strip().splitlines()
            for line in lines[:-1]:
                print(f"[{label}] {line}")
            result = json.loads(lines[-1])
            runs.append((label, result))
            print(f"[{label}] {json.dumps(result)} ({card})", flush=True)
        if not all(r["bitwise_repeatable"] for _, r in runs):
            failures.append("a tree's two launches gave different results")
        want, got = torch.load(saved["parent"]), torch.load(saved["change"])
        for tag in want:
            for name, g, w in zip(("out", "lse"), got[tag], want[tag]):
                err = (g.float() - w.float()).abs()
                print(f"{tag} {name}: change against parent {'bitwise equal' if torch.equal(g, w) else 'differs'}, "
                      f"max_abs_err {err.max().item():.3e} mean_abs_err {err.mean().item():.3e}")
                limits = (FWD_MAX_ABS, FWD_MEAN_ABS) if name == "out" else (LSE_MAX_ABS, LSE_MAX_ABS)
                if err.max().item() > limits[0] or err.mean().item() > limits[1]:
                    failures.append(f"{tag} {name}: the trees disagree (limits {limits})")
                if tag.startswith(BITWISE) and not torch.equal(g, w):
                    failures.append(f"{tag} {name}: not bitwise the parent's")
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
    if failures:  # the times above stand, but the two trees do not compute the same
        raise SystemExit("; ".join(failures))

if __name__ == "__main__":
    main()
