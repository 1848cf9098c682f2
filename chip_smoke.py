"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py             # from the repository root; needs one card
    python3 chip_smoke.py --profile   # also prints torch.profiler kernel tables
    python3 chip_smoke.py --tracing   # phases 1, 2 and 24 alone (~3 min)
    python3 chip_smoke.py --kimivl    # phases 1, 2 and 25 alone
    python3 chip_smoke.py --decode    # phases 1, 2 and 13(b) alone (~4 min)
    python3 chip_smoke.py --images    # phases 1, 2 and 26 alone

Phases (each prints its result; any failure raises and the exit code is 1):
  1. device: the card's name and power limit;
  2. build: nvcc builds the attention kernels from g2vlm_tpu_torch/csrc, one
     process per source, in parallel;
  3. K1 (batched attention) against its plain version at the recon shapes
     (and DINOv3's, phase 21),
     two launches bitwise equal, each case beside its bound and the library
     call;
  4. K2 (segment attention) against its plain (chunked) version at the
     32-view recon prefill, a small mixed case, the DINOv3 recon prefill and an
     extreme-logit case,
     two launches bitwise equal, each case beside its bound and the library
     call;
  5. recon parity: a full-width, cut-depth model runs recon_from_frames on the
     card in bf16 (kernels) and on the CPU in fp32 (plain versions);
  6. the recon slice: G2VLMConfig(visual_und=False) with random bf16 weights, 32
     uint8 views of 294x518, launch counts (every K2 launch of the call in
     the warp-specialised schedule), shapes, finiteness and timing;
  7. K3 / K6 (the lse forwards): out bitwise equal to K2 / K1, lse against the
     plain version, at the training shapes (and phase 16's), two launches bitwise equal, each
     case beside its bound and the library call;
  8. K5 / K7 (the dq and dkv backward kernels) against the plain backward at
     the training shapes, a ragged pack and one with whole rows and columns of
     SKIP tiles, with exact zeros for rows and keys that see nothing and two
     launches bitwise equal; dq+dk+dv timed against the function's bound (the
     5 products it needs);
  9. train parity: one forward + backward of the cut-depth full-width model on
     the card (fp32 masters, bf16 compute, kernels) against the CPU (fp32,
     plain versions): loss, gradient norms and launches, with per-layer
     checkpoints, with groups of two layers checkpointed (remat_group=2) and
     with the Pi3 heads one view at a time (head_view_chunk=1);
 10. the training slice: the recon-stage step of train_torch.py at full width
     and depth (16 views of 294x518 in a 12,800-token pack, SPLIT layout, und
     expert frozen, factored Adam with a bf16 first moment, EMA, per-layer
     checkpointing), a few steps on one repeated batch;
 11. K2 at head dim 80, K4 (the two-stage forward) and K8 (the int8-QK forward)
     against their plain versions at the chat prefill (48,384 rows), one ViT
     chunk (11,664 rows, 16 heads of 80), a small ragged mixed case and, for
     K8, outlier and extreme-logit inputs; K4 is also held against K2; two
     launches of K2, K4 and K8 bitwise equal; each case beside its bound and
     the library call (K2 at head dim 80 and K8 also beside the parent's
     times, K8 beside K2);
 12. chat parity: a full-width, cut-depth model answers on the card in bf16
     (kernels; default, pipelined and int8 attention; the int8 KV cache, the
     host preprocess, and generate_batched on two prompts of different
     lengths) and on the CPU in fp32: prefill hidden states, the first decode
     step's logits, ids in the vocabulary, launch counts;
 13. the chat slice: G2VLMConfig() with random bf16 weights, 32 uint8 views of
     294x518, chat(device_preprocess=True) for 32 new tokens: launch counts,
     finite logits, ids in the vocabulary and repeatable, chat_continue, the
     decode loop eager and as a CUDA graph, TTFT by stage, tokens/s, memory;
     (b) the decode step on the fused kernels (ops/decode_fused.py) against
     the chain at chat-short's prompts (1 and 4 views of 480x640, 64 words):
     pipe.chat's own launches of the kernels (56 decode_attention, 114
     add_rms_norm: the eager step and the captured one), the kernels of one
     replayed step by the profiler, the replayed step timed in turns (chain,
     fused, fused, chain), the eager step's launches (28 decode_attention, 57
     add_rms_norm); each kernel alone against its plain version (output and
     stored rows within one bf16 step on at most 1% of elements), its bound and
     the library call (one-row GQA SDPA, F.rms_norm), and decode_attention
     beside the design not taken (a norm / RoPE / store kernel, then the
     library's attention over the capacity with a mask);
 14. the same call, and the 32-view recon call, with attn_impl="int8" (K8) and
     with attn_pipe=True (K4);
 15. the recon entry path from files on disk: (a) a full-width checkpoint cut in
     depth (2 DINOv2, 2 decoder and 2 ViT layers, vocab 5,120; the Pi3 heads at
     their full depth, which the reference's config files cannot cut) written by
     the port's `weights.save_safetensors`, audited by `python -m g2vlm_tpu_torch.weights --audit`, loaded
     by `load_checkpoint` bitwise equal, and `G2VLMPipeline.recon` on 8 PNG
     views bitwise equal on the loaded and the original model, with K1 / K2
     launch counts; (b) `infer_recon_torch.py` on 32 PNG views of 294x518 at
     full size (a PLY whose header, size and vertex count agree with what the
     script reports), then `pipe.recon` on those paths in process, timed
     whole and in synchronised spans: host `load_views`, host normalisation,
     upload, forward, copies to numpy; (c) `eval_points_torch.py` and
     `eval_camera_torch.py` on a synthetic scene at full size, both at once
     (exit 0, finite scores);
 16. K3 and K5 at head dim 80, the ViT's training shape (23,328 rows, 16:16
     heads, 8 images of 2,916 rows each a segment), against their plain
     versions as in phases 7-8 (run as the last case of their loop), beside
     their bounds and the library call;
 17. the joint training step: (a) a cut-depth, full-width G2VLMConfig() with the
     ViT, --freeze_recon, one pack of 2 DINOv2 views and 2 ViT images, on the
     card (fp32 masters, bf16 compute, kernels) against the CPU (fp32): loss,
     gradient norms, launch counts; (b) G2VLMConfig() at full width and depth
     (4.54 B parameters), --split_layout --freeze_recon --factored_v --mu_dtype
     bfloat16, per-layer and per-block checkpointing, on one pack built by the
     port's SequencePacker from PNG files as a recon_then_und sample lays it out
     (8 DINOv2 views of 294x518, 8 ViT images of 768x768 smart-resized to
     756x756, a question and a 32-token answer; 12,137 tokens in 12,800 rows):
     host ms per pack, ms per step, real tokens/s, peak memory, exact launch
     counts, frozen leaves and their EMA bitwise unchanged;
 18. the data path and resume through train_torch.py --data_config at cut depth
     (synthetic scenes and image conversations, both groups): run A takes 4
     steps with a checkpoint every 2, run B 2 steps and then 2 more with
     --resume; B's steps 2-3 against A's within 1e-3, data_status equal, a
     checkpoint restored onto the card bitwise its file, write and restore
     seconds. Subprocesses with PYTHONHASHSEED=0; the YAML is written with
     PyYAML, whose absence fails the phase;
 19. the conf-head stage (train_torch.py --train_conf): (a) a cut-depth,
     full-width G2VLMConfig(visual_und=False, train_conf_pi3=True) step on the
     card against the CPU fp32 run (loss, local_conf_loss, gradient norms with
     the conf decoder's, launch counts) and the frozen SegFormer's logits and
     sky mask; (b) phase 10's step at full width and depth with the conf decoder
     and head and the in-program sky masks of a SegFormer with random weights
     from the seed: ms per step, real tokens/s, peak memory, exact launch
     counts, the SegFormer (and a sample of the other frozen leaves) and their
     EMA bitwise unchanged;
 20. the "moe" and "dense" decoder layers: (a) the 32-view recon call with each
     (random bf16 weights; a MIXED prefill of 25,088 rows): launch counts,
     finite outputs, latency, memory; (b) cut-depth parity against the CPU of
     recon and of the chat prefill with its first decode step, for each; (c)
     --model_path <cut 'mot' checkpoint> --bootstrap_moe: the checkpoint
     written, loaded on both devices, the geo expert copied from the base
     expert, one step card vs CPU (loss, gradient norms, launches);
 21. the DINOv3 geometry tower (use_dinov3, Dinov3Config(): ViT-L/16): (a)
     cut-depth parity of recon_from_frames(new_width=512) against the CPU; (b)
     the 32-view call at full size on 288x512 views (launch counts, latency,
     memory). Its K1 shape (32, 581, 16, 64) runs in phase 3's loop and its K2
     prefill (32 views of 18 x 32 patches) in phase 4's;
 22. configs/joint_train.yaml's three groups (recon, recon_then_und, vlm_sft; its
     order, weights, mandatory flags and transform arguments) over data written
     from a seed: JSONL scenes, SPAR-style parquet rows (PNG views, 16-bit depth,
     poses, intrinsics, markers; scannet and structured3d), image conversations
     and a video row on a folder of PNG frames; pyarrow's version printed.
     It runs right after phase 17: (b) takes phase 17's model and train state
     and steps at full width and depth on packs PackedIterableDataset draws
     from the three groups: steps fed inline, then through a one-worker
     PrefetchLoader (a thread) and a one-worker ProcessPrefetchLoader (a spawned
     process), whose packs equal the inline ones array for array; host ms per
     pack, ms per step and real tokens/s each way, the time each loader hides,
     the worker's ms per pack and, for the process, where a pack's wait goes
     (unpickling, pickling, the rest in the pipe), peak memory, launches derived
     per pack, frozen leaves unchanged; (a) train_torch.py --data_config at
     phase 18's cut depth and flags: run A against run B resumed (1e-3,
     data_status with the parquet cursor equal), then the CE of each group's
     answer tokens on A's first pack; (c) the chat call of
     G2VLMConfig() on 8 frames sampled (mode "middle") from a folder of 64 PNGs
     of 294x518: TTFT, ms per token, launches, ids; then infer_chat_torch.py
     --video on the folder;
 23. the multi-GPU layer (parallel/mesh.py, parallel/sequence.py) on the card: (a) phase 10's step at full
     width through FSDP2 / DTensor on a one-rank NCCL group (make_mesh(1, dp=1, fsdp=1, tp=1), shard_model):
     the first loss within 1e-3 of phase 10's (and whether bitwise), phase 10's launch counts exactly, frozen
     leaves and their EMA bitwise unchanged, ms per step, real tokens/s and peak memory beside phase 10's;
     (b) K3 and K5 at the shapes sequence parallelism gives them, a query shard of S / n rows against the
     whole K / V for each rank of n in {2, 4}, on phase 10's 12,800-row pack, and K2 so on the 25,088-row
     recon prefill: the shards' outputs and lse (2e-3 of max|ref|, and whether bitwise) and their summed
     dk / dv and concatenated dq (1e-2) against the unsharded launch, each shard's ms beside the unsharded;
     (c) with two cards or more, the cut-depth step on 2 NCCL ranks (fsdp=2, sequence parallel) against
     one rank;
 24. the program's spans (g2vlm_tpu_torch/utils/tracing.py) at full width: one 32-view recon call
     (294x518) and one 4-view chat request (480x640, the default preprocess) under torch.profiler, each
     span tree with host and device ms; recon's four stage spans (input, dino, decoder, heads) against
     the profiler's busy time for the call plus the idle inside them (90-110%); every idle gap of 10 us
     or more attributed by time overlap to the innermost span open over it; the `upload.bytes` counter
     against the trace's host-to-device copies; the chat request again with `return_info` (its stage
     syncs); then the recorder on (`tracing.record()`) against off in turns, recon x6 and chat x6 (and
     chat with `return_info` x6), the cost when on. `--tracing` runs phases 1, 2 and 24 alone.
 25. the "mla_moe" decoder (Kimi-VL-A3B's language model, benchmark/configs/g2vlm-kimivl-a3b-bf16.json)
     at full width and cut depth (layer 0 and 4 MoE layers; the towers and heads 2 layers each): (a) one
     chat request (2 views of 480x640, 24 words, 8 greedy tokens) in bf16, then its prefill, latent
     cache and absorbed decode steps over the served tokens against the float32 reference's one full
     forward (benchmark/reference/kimivl.py): the logits' relative error (3e-2) and the reference's gap
     below its best at each served token; (b) the MLA forward at the 32-view recon prefill (25,088
     rows, 16:16 heads, QK 192 / V 128) against its plain version, two launches bitwise equal, timed
     beside its bound and the library's masked call; (c) the same chat request at full size (4 views),
     three times: prefill, latent cache and the graph-captured decode of 27 layers, timed; then one
     32-view recon call of 294x518, its launches gated (K1 44, the MLA forward 27).
     `--kimivl` runs phases 1, 2 and 25 alone.
 26. the chat images' resample (ops/resample.py): each of its three kernels at chat-short's shapes (4
     frames of 480x640; LANCZOS to 392x518, bicubic to 768x768 then 756x756) bitwise its plain version
     and Pillow, timed beside its bytes bound, its plain version on the card and F.interpolate; a
     4-frame request's views and ViT rows on the kernels against the host PIL path, both timed; then
     G2VLMConfig() in bf16: 6 launches a chat request of 1-4 frames, its served ids those of the PIL
     path. `--images` runs phases 1, 2 and 26 alone.
Every kernel is also timed beside the one PyTorch library call that computes
the same function (a yardstick only; the port never calls it). The last line is
{"ok": true, "device": {...}}; before it, the card's line and one JSON line
that lists the kernels with their launches, errors, times and bounds.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from types import SimpleNamespace

# the card's published peaks (H100 SXM): dense bf16 and int8 tensor-core rates and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
# limits of a bf16 kernel against its plain fp32 version
FWD_MAX_ABS, FWD_MEAN_ABS = 2e-2, 1e-3  # forwards: outputs are O(1)
# backwards, relative to the plain result (max |err| / max |ref|, mean |err| / mean |ref|): P and dS
# are rounded to bf16 before the second products and every output once more (2^-9 = 2e-3 each), so
# the mean cannot reach the 1e-3 of the forwards; seen on the H100: max 5.0e-3, mean 2.2e-3 to 2.8e-3
BWD_MAX_REL, BWD_MEAN_REL = 2e-2, 5e-3
LSE_MAX_ABS = 2e-3
# K2 at one ViT chunk (11,664 rows, 16:16 heads of 80) in the mma.sync kernel that attention_segment.cu
# replaced (PERF.md section 6); printed beside this run's time
PARENT_K2_D80_MS = 1.604
# K8 in the mma.sync kernel that the kInt8 form of attention_segment.cu replaced, at the chat prefill
# and one ViT chunk (PERF.md section 6), and the int8 chat call's TTFT before it; printed beside this run's
PARENT_K8_MS = {"chat_prefill_32_views": 91.014, "vit_chunk_4_images": 1.774}
PARENT_INT8_TTFT_MS = 4591.3
TRAIN_VIEWS, TRAIN_HW, TRAIN_TOKENS = 16, (294, 518), 12800
# the joint step's ViT images: 8 of 768x768, smart-resized to 756x756 = 54 x 54 patch rows each
VIT_TRAIN_IMAGES, VIT_ROWS_PER_IMAGE = 8, 2916


def _launches(fa) -> dict:
    """The kernels' launches since the last `reset_launch_counts`, those at 0 left out. The schedule's
    counter `flash_segment_attention_ws` (the K2 / K3 launches of the warp-specialised schedule, a share
    of theirs) is left out too: phase 6 gates it."""
    return {k: v for k, v in fa.launch_counts.items() if v and k != "flash_segment_attention_ws"}


def _bf16_steps(got, want):
    """(most bf16 steps apart, share of elements apart) of two bf16 tensors: the test of a fused
    kernel against its plain version, whose fp32 sums run in another order, so that a value on a
    rounding boundary may round either way (tests/test_torch_cuda_decode.py's criterion)."""
    import torch

    apart = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    return int(apart.max().item()), (apart > 0).float().mean().item()


# a fused decode kernel against its plain version: at most one bf16 step, on at most this share
MAX_SHARE_ONE_STEP = 1e-2


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _timed_in_turns(kernel, plain, iters: int):
    """Both warm, in turns (plain, kernel, kernel, plain); returns (kernel ms, plain ms)."""
    kernel(), plain()
    p1 = _time_ms(plain, iters)
    k1 = _time_ms(kernel, iters)
    k2 = _time_ms(kernel, iters)
    p2 = _time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _compare_timed(kernel, plain, iters: int):
    """Errors of kernel() against plain(), then both timed in turns."""
    import torch

    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError("kernel output is not finite")
    err = (got.float() - want.float()).abs()
    ms, plain_ms = _timed_in_turns(kernel, plain, iters)
    return err.max().item(), err.mean().item(), ms, plain_ms


def _library_ms(fn, iters: int):
    """(time of a PyTorch library call, None), or (None, reason) where it cannot run."""
    import torch

    try:
        fn()
        torch.cuda.synchronize()
        return _time_ms(fn, iters), None
    except (RuntimeError, TypeError) as e:  # out of memory, or an argument this PyTorch lacks
        torch.cuda.empty_cache()
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"


def _bound(n_bytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the bf16 tensor-core peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def _attention_bound(pairs, heads, d, n_products, rows_q, rows_kv, kv_heads, n_q_shaped, n_kv_shaped, stat_rows=0):
    """Bound of an attention kernel: `n_products` matrix products of
    2 * pairs * d operations per query head; `n_q_shaped` bf16 tensors of the q
    shape and `n_kv_shaped` of the kv shape read or written once each, plus
    `stat_rows` fp32 per-row statistics (lse, delta)."""
    flops = n_products * 2.0 * pairs * d * heads
    n_bytes = 2.0 * d * (n_q_shaped * rows_q * heads + n_kv_shaped * rows_kv * kv_heads) + 4.0 * stat_rows
    return _bound(n_bytes, flops)


def _batched_bound(b, s, m, kb, h, d, valid, lse=False):
    """Bound of K1 / K6: the two products over the keys that count; q and out once, the K/V rows
    that count once (frame-0 cross attention reads one batch element of K/V), and lse."""
    keys = m if valid is None else valid
    return _attention_bound(b * s * keys, h, d, 2, b * s, kb * keys, h, 2, 2, stat_rows=b * s * h if lse else 0)


def _keys_that_count(t, valid):
    """K or V (B, M, H, D) cut to its first `valid` keys for the library call, which then runs
    unmasked on its fastest backend; the whole tensor where every key counts."""
    return t if valid is None else t[:, :valid]


def _ratio(ms, library_ms):
    """The kernel's time over the library call's, as text for a result line."""
    return f"; kernel / library {ms / library_ms:.2f}x" if library_ms else ""


def _step_launches(c, chunks=1, remat_group=1, dino_remat_group=1, vit=False, freeze_recon=False):
    """Launches of one training step, derived from the config: every layer's lse forward runs
    twice (the forward, and its recomputation under per-layer checkpointing), each backward
    kernel once; the Pi3 decoders run once per view chunk. Groups of g > 1 layers checkpointed
    around the per-layer checkpoints run g - 1 more forwards a group: the group's recomputation
    stops once the last layer's input is back, and that layer's own checkpoint recomputes it.
    `vit`: the pack holds ViT images and the ViT trains: each of its blocks (one checkpoint a
    block) runs K3 twice and K5 once, at head dim 80. `freeze_recon`: DINOv2 and its inputs get
    no gradient, so it runs the plain forward K1 once a layer and no backward; the Pi3 heads,
    frozen too, still see hidden states that need a gradient and keep K6 / K7. The conf decoder
    (`train_conf_pi3`) is one more Pi3 decoder of self-attention blocks."""
    def lse(layers, group):
        return 2 * layers + (layers // group * (group - 1) if group > 1 else 0)

    pi3 = c.pi3.depth * (2 + 2 * c.use_global_points + c.train_conf_pi3) * chunks
    segment = c.llm.num_hidden_layers + (c.vit.depth if vit else 0)
    segment_lse = lse(c.llm.num_hidden_layers, remat_group) + (2 * c.vit.depth if vit else 0)
    dino = c.dino.num_hidden_layers
    out = {"flash_segment_attention_lse": segment_lse, "flash_segment_attention_bwd_dq": segment,
           "flash_segment_attention_bwd_dkv": segment}
    if freeze_recon:
        out.update({"flash_batched_attention": dino, "flash_batched_attention_lse": 2 * pi3,
                    "flash_batched_attention_bwd_dq": pi3, "flash_batched_attention_bwd_dkv": pi3})
    else:
        out.update({"flash_batched_attention_lse": lse(dino, dino_remat_group) + 2 * pi3,
                    "flash_batched_attention_bwd_dq": dino + pi3, "flash_batched_attention_bwd_dkv": dino + pi3})
    return out


def _rel_errors(got, want):
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    return (err.max() / ref.max()).item(), (err.mean() / ref.mean()).item(), err.max().item()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one recon call, one training step and one chat call")
    ap.add_argument("--tracing", action="store_true", help="run phases 1, 2 and 24 (the program's spans) alone")
    ap.add_argument("--kimivl", action="store_true", help="run phases 1, 2 and 25 (the mla_moe decoder) alone")
    ap.add_argument("--decode", action="store_true", help="run phases 1, 2 and 13(b) (the fused decode step) alone")
    ap.add_argument("--images", action="store_true", help="run phases 1, 2 and 26 (the chat images' resample) alone")
    args = ap.parse_args()

    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    import torch.nn.functional as F

    from g2vlm_tpu_torch.ops import flash_attention as fa
    from g2vlm_tpu_torch.ops.masks import make_segment_mask, make_token_info

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = _gpu_line()
    print(f"[device] {name} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    paths, log = fa.build_library()
    fa.load_library()
    print(f"[build] {', '.join(p.name for p in paths)} in {time.perf_counter() - t0:.2f} s")
    entry = ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        if ("registers" in line or "spill" in line) and "nv_bfloat16" in entry:
            print(f"[build] {entry[-64:]}: {line.strip()[:150]}")

    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def sdpa(q, k, v, **kw):  # (S, H, D) or (B, S, H, D) -> the library's (B, H, S, D)
        q, k, v = (t.transpose(-3, -2) if t.dim() == 4 else t.transpose(0, 1)[None] for t in (q, k, v))
        return F.scaled_dot_product_attention(q, k, v, **kw)

    kernels = {}  # name -> the entry of the final JSON line

    def entry_for(kname, replaces, source="g2vlm_tpu_torch/csrc/attention_segment.cu"):
        return kernels.setdefault(kname, {
            "name": kname, "route": "cuda", "source": source, "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
        })

    def visible_pairs(info, q_chunk=2048):
        """Query-key pairs the mask makes visible: what this run's data needs, and what the
        bounds of the segment kernels count."""
        return sum(int(make_segment_mask(info.slice(q0, q_chunk), info).sum().item())
                   for q0 in range(0, info.seq_len, q_chunk))

    def live_pairs(info):
        """Query-key pairs in the tiles the codes do not mark SKIP: the work the tile codes make
        the kernels do, at least `visible_pairs`."""
        meta = info.packed()
        return int((fa.block_codes(meta, meta) != fa.BLOCK_SKIP).sum().item()) * fa.TILE * fa.TILE

    def gqa_mask_call(q, k, v, info):
        """The library call for the segment kernels: GQA attention with the
        boolean segment mask materialised beforehand."""
        mask = make_segment_mask(info, info)
        return lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)

    mixed = make_token_info([100, 156], [40, 60, 56, 100], ["causal", "full", "causal", "noise"],
                            pad_to=320, device=dev)
    env = SimpleNamespace(args=args, dev=dev, card=card, gen=gen, rnd=rnd, sdpa=sdpa, kernels=kernels, steps={},
                          entry_for=entry_for, visible_pairs=visible_pairs, live_pairs=live_pairs,
                          gqa_mask_call=gqa_mask_call, mixed=mixed)

    # launches of each main path's run: counts set to 0 just before it, read just after
    paths_run = {}
    alone = args.tracing or args.kimivl or args.decode or args.images
    if not alone:
        paths_run["recon_call"], paths_run["train_step"], recon_ms = _recon_and_train_phases(env)
        paths_run.update(_chat_phases(env, recon_ms))
    if not (args.tracing or args.kimivl or args.images):
        paths_run.update(_decode_phase(env))
    if not (args.tracing or args.kimivl or args.decode):
        paths_run.update(_images_phase(env))
    if not alone:
        paths_run["recon_entry"] = _recon_entry_phase(env)
        paths_run["joint_step"], joint = _joint_step_phase(env)
        paths_run.update(_three_group_phases(env, joint))  # 22(b) steps on phase 17's model and state
        del joint
        _data_resume_phase(env)
        paths_run["conf_step"] = _conf_stage_phase(env)
        paths_run.update(_dense_moe_phase(env, recon_ms))
        paths_run["recon_dinov3"] = _dinov3_phase(env, recon_ms)
        paths_run.update(_parallel_phase(env))
    if not (args.kimivl or args.decode or args.images):
        _tracing_phase(env)
    if not (args.tracing or args.decode or args.images):
        paths_run["kimivl_chat"] = _kimivl_phase(env)

    for kname, e in kernels.items():
        for path, counts in paths_run.items():
            e["launches_" + path] = counts.get(kname, 0)
        e["launches"] = sum(counts.get(kname, 0) for counts in paths_run.values())
        if e["launches"] == 0:
            _fail(f"kernel {kname} was launched on no main path")
        missing = {"ms", "plain_ms", "bound_ms", "bound_by", "library_ms"} - set(e)
        if missing:
            _fail(f"kernel {kname} lacks {sorted(missing)} in the kernels line")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def _recon_and_train_phases(env):
    """Phases 3-10. Returns (launches of the 32-view recon call, launches of
    the last training step, ms per recon call)."""
    import numpy as np
    import torch

    import train_torch
    from g2vlm_tpu_torch.config import G2VLMConfig, cut_depth_config
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
    from g2vlm_tpu_torch.ops import flash_attention as fa
    from g2vlm_tpu_torch.ops.masks import TokenInfo, make_segment_mask, make_token_info
    from g2vlm_tpu_torch.train import trainer
    from g2vlm_tpu_torch.weights import build_model

    args, dev, card, gen, rnd, sdpa = env.args, env.dev, env.card, env.gen, env.rnd, env.sdpa
    entry_for, visible_pairs, gqa_mask_call, mixed = env.entry_for, env.visible_pairs, env.gqa_mask_call, env.mixed

    batched_src = "g2vlm_tpu_torch/csrc/attention_batched.cu"
    k1e = entry_for("flash_batched_attention", "g2vlm_tpu/ops/flash_attention.py:1058", batched_src)
    k2e = entry_for("flash_segment_attention", "g2vlm_tpu/ops/flash_attention.py:168")
    k3e = entry_for("flash_segment_attention_lse", "g2vlm_tpu/ops/flash_attention.py:239")
    bwd_src = "g2vlm_tpu_torch/csrc/attention_bwd.cu"
    k5q = entry_for("flash_segment_attention_bwd_dq", "g2vlm_tpu/ops/flash_attention.py:385", bwd_src)
    k5kv = entry_for("flash_segment_attention_bwd_dkv", "g2vlm_tpu/ops/flash_attention.py:435", bwd_src)
    k6e = entry_for("flash_batched_attention_lse", "g2vlm_tpu/ops/flash_attention.py:1127", batched_src)
    k7q = entry_for("flash_batched_attention_bwd_dq", "g2vlm_tpu/ops/flash_attention.py:1164", bwd_src)
    k7kv = entry_for("flash_batched_attention_bwd_dkv", "g2vlm_tpu/ops/flash_attention.py:1195", bwd_src)


    # ---- 3. K1 -------------------------------------------------------------
    k1_cases = [
        ("dinov2", 32, 782, 782, 16, 64, None, False),
        ("pi3_self", 32, 777, 777, 16, 96, None, False),
        ("pi3_cross_frame0", 32, 777, 777, 16, 96, None, True),
        ("pi3_self_valid_kv", 32, 777, 777, 16, 96, 700, False),
        # phase 21's shape: DINOv3 at 288x512 views, 18 x 32 patches + CLS + 4 registers
        ("dinov3", 32, 581, 581, 16, 64, None, False),
    ]
    for tag, b, s, m, h, d, valid, cross in k1_cases:
        q = rnd(b, s, h, d)
        kb = 1 if cross else b
        k = rnd(kb, m, h, d).expand(b, m, h, d)
        v = rnd(kb, m, h, d).expand(b, m, h, d)
        qf, kf, vf = q.float(), k.float(), v.float()
        mx, mean, ms, plain_ms = _compare_timed(
            lambda: fa.flash_batched_attention(q, k, v, valid_kv=valid),
            lambda: fa.flash_batched_attention_reference(qf, kf, vf, valid_kv=valid),
            iters=20,
        )
        print(f"[K1] {tag} q{(b, s, h, d)} kv{(kb, m, h, d)} valid_kv={valid}: max_abs_err {mx:.3e} "
              f"mean_abs_err {mean:.3e} kernel {ms:.3f} ms plain {plain_ms:.3f} ms ({card})")
        if mx > FWD_MAX_ABS or mean > FWD_MEAN_ABS:
            _fail(f"K1 {tag} disagrees with its plain version (max {mx}, mean {mean})")
        if not torch.equal(fa.flash_batched_attention(q, k, v, valid_kv=valid),
                           fa.flash_batched_attention(q, k, v, valid_kv=valid)):
            _fail(f"K1 {tag}: two launches gave different outputs")
        k1e["max_abs_err"] = max(k1e["max_abs_err"], mx)
        lib, why = _library_ms(lambda: sdpa(q, _keys_that_count(k, valid), _keys_that_count(v, valid)), 20)
        bound_ms, by = _batched_bound(b, s, m, kb, h, d, valid)
        at = dict(shape=f"q({b},{s},{h},{d}) kv({kb},{m},{h},{d}) valid_kv={valid}", ms=ms, plain_ms=plain_ms,
                  bound_ms=bound_ms, bound_by=by, library_ms=lib)
        k1e.setdefault("at", {})[tag] = at
        if tag == "dinov2":
            k1e.update({key: at[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                       shape=f"({b},{s},{h},{d})")
        print(f"[K1] {tag}: two launches bitwise equal; bound {bound_ms:.4f} ms by {by} ({bound_ms / ms * 100:.1f}%); "
              f"library scaled_dot_product_attention {lib} ms {why or ''} ({card})")

    # ---- 4. K2 -------------------------------------------------------------
    shape_pipe = G2VLMPipeline(None, G2VLMConfig(visual_und=False))
    pre = shape_pipe.build_recon_prefill(32, 21, 37)
    recon_info = pre.token_info(dev)
    # phase 21's prefill: 32 DINOv3 views of 18 x 32 patches
    dinov3_info = shape_pipe.build_recon_prefill(32, 18, 32).token_info(dev)

    for tag, info, h, kvh, d, iters in (
        ("recon_prefill_32_views", recon_info, 12, 2, 128, 5),
        ("mixed_docs_padded", mixed, 12, 2, 128, 20),
        ("recon_prefill_32_views_dinov3", dinov3_info, 12, 2, 128, 5),
    ):
        n = info.seq_len
        q, k, v = rnd(n, h, d), rnd(n, kvh, d), rnd(n, kvh, d)
        qf, kf, vf = q.float(), k.float(), v.float()
        plan = fa.segment_plan(info, info)  # made once per forward on the main path, so outside the kernel's time
        mx, mean, ms, plain_ms = _compare_timed(
            lambda: fa.flash_segment_attention(q, k, v, info, info, plan=plan),
            lambda: fa.flash_segment_attention_reference(qf, kf, vf, info, info),
            iters=iters,
        )
        if mx > FWD_MAX_ABS or mean > FWD_MEAN_ABS:
            _fail(f"K2 {tag} disagrees with its plain version (max {mx}, mean {mean})")
        if not torch.equal(fa.flash_segment_attention(q, k, v, info, info, plan=plan),
                           fa.flash_segment_attention(q, k, v, info, info, plan=plan)):
            _fail(f"K2 {tag}: two launches gave different outputs")
        k2e["max_abs_err"] = max(k2e["max_abs_err"], mx)
        lib, why = _library_ms(gqa_mask_call(q, k, v, info), iters)
        bound_ms, by = _attention_bound(visible_pairs(info), h, d, 2, n, n, kvh, 2, 2)
        print(f"[K2] {tag} q{(n, h, d)} kv{(n, kvh, d)}: max_abs_err {mx:.3e} mean_abs_err {mean:.3e}, two launches "
              f"bitwise equal; kernel {ms:.3f} ms, bound {bound_ms:.4f} ms by {by} ({bound_ms / ms * 100:.1f}%), "
              f"plain {plain_ms:.3f} ms, library scaled_dot_product_attention (enable_gqa, materialised mask) "
              f"{lib} ms {why or ''}{_ratio(ms, lib)} ({card})")
        if tag == "recon_prefill_32_views":
            out = fa.flash_segment_attention(q, k, v, info, info)
            if (out[info.doc_id < 0] != 0).any():
                _fail("K2: padding rows that see no key are not 0")
            del out
            k2e.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, library_ms=lib,
                       shape=f"({n},{h}:{kvh},{d})")
        if tag == "recon_prefill_32_views_dinov3":
            k2e.setdefault("at", {})[tag] = dict(shape=f"({n},{h}:{kvh},{d})", ms=ms, plain_ms=plain_ms,
                                                 bound_ms=bound_ms, bound_by=by, library_ms=lib)
    del q, k, v, qf, kf, vf
    torch.cuda.empty_cache()

    # extreme logits (tests/test_flash_attention.py:287): ties at ~220 nats give
    # the uniform mean; one extreme row among normal ones stays finite
    s, h, kvh, d = 128, 2, 2, 128
    v0 = torch.randn(d, generator=gen, device=dev)
    v0 /= v0.norm()
    q = (50.0 * v0).expand(s, h, d).to(torch.bfloat16).contiguous()
    v = rnd(s, kvh, d)
    full = make_token_info([s], [s], ["full"], device=dev)
    out = fa.flash_segment_attention(q, q[:, :kvh].contiguous(), v, full, full)
    want = v.float().mean(0, keepdim=True).expand(s, kvh, d)
    q2, k2 = rnd(s, h, d), rnd(s, kvh, d)
    q2[7] = (60.0 * v0).to(torch.bfloat16)
    k2[11] = (60.0 * v0).to(torch.bfloat16)
    out2 = fa.flash_segment_attention(q2, k2, v, full, full)
    torch.cuda.synchronize()
    ext = (out.float() - want).abs().max().item()
    print(f"[K2] extreme_logits: uniform-mean max_abs_err {ext:.3e}, "
          f"finite {bool(torch.isfinite(out).all())} / {bool(torch.isfinite(out2).all())}")
    if ext > 1e-2 or not torch.isfinite(out2).all():
        _fail("K2 extreme-logit case")

    # ---- 5. recon parity: card bf16 (kernels) vs CPU fp32 (plain) -------------
    full_cfg = G2VLMConfig(visual_und=False)
    cut = cut_depth_config(full_cfg, 2)
    token_ids = dict(bos_token_id=1, eos_token_id=2, start_of_image=3, end_of_image=4)
    frames2 = np.random.default_rng(1).integers(0, 256, (2, 294, 518, 3), dtype=np.uint8)
    cpu_model = build_model(cut, device="cpu", dtype=torch.float32, seed=0)
    t0 = time.perf_counter()
    want = G2VLMPipeline(cpu_model, cut, new_token_ids=token_ids).recon_from_frames(frames2)
    cpu_s = time.perf_counter() - t0
    gpu_model = build_model(cut, device=dev, dtype=torch.bfloat16, seed=None)
    gpu_model.load_state_dict(cpu_model.state_dict())
    fa.reset_launch_counts()
    got = G2VLMPipeline(gpu_model, cut, new_token_ids=token_ids).recon_from_frames(frames2)
    torch.cuda.synchronize()
    launches = _launches(fa)
    want_k1 = cut.dino.num_hidden_layers + cut.pi3.depth * (2 + 2 * cut.use_global_points)
    if launches != {"flash_batched_attention": want_k1, "flash_segment_attention": cut.llm.num_hidden_layers}:
        _fail(f"recon parity: the card run did not go through the kernels: {launches}")
    for key in ("local_points", "camera_poses", "global_points", "points"):
        a, b = got[key].float().cpu(), want[key]
        rel = ((a - b).abs().max() / b.abs().max()).item()
        print(f"[parity] {key} {tuple(a.shape)}: max|gpu-cpu|/max|cpu| {rel:.3e} (budget 3e-2)")
        if not torch.isfinite(a).all() or rel > 3e-2:
            _fail(f"recon parity: {key} off by {rel} (budget 3e-2)")
    print(f"[parity] cut-depth full-width recon, 2 views: cpu fp32 {cpu_s:.1f} s, launches {launches}")
    del gpu_model, got, want

    # ---- 6. the recon slice ----------------------------------------------------
    cfg = full_cfg
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[slice] random bf16 init of {n_params / 1e9:.3f} B parameters on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    pipe = G2VLMPipeline(model, cfg)
    frames = np.random.default_rng(0).integers(0, 256, (32, 294, 518, 3), dtype=np.uint8)
    want_k1 = cfg.dino.num_hidden_layers + cfg.pi3.depth * (2 + 2 * cfg.use_global_points)
    want_k2 = cfg.llm.num_hidden_layers

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    out = pipe.recon_from_frames(frames)
    torch.cuda.synchronize()
    recon_launches = _launches(fa)
    if recon_launches != {"flash_batched_attention": want_k1, "flash_segment_attention": want_k2}:
        _fail(f"recon slice: launches {recon_launches}, expected K1 {want_k1} and K2 {want_k2} per call")
    if fa.launch_counts["flash_segment_attention_ws"] != want_k2:  # head dim 128: the warp-specialised schedule
        _fail(f"recon slice: {fa.launch_counts['flash_segment_attention_ws']} K2 launches of the warp-specialised "
              f"schedule, expected {want_k2}")
    shapes = {"points": (32, 294, 518, 3), "local_points": (32, 294, 518, 3),
              "global_points": (32, 294, 518, 3), "camera_poses": (32, 4, 4)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
            _fail(f"recon slice: {key} has shape {tuple(out[key].shape)} or non-finite values")
    rot = out["camera_poses"][:, :3, :3]
    orth = (rot @ rot.transpose(1, 2) - torch.eye(3, device=dev)).abs().max().item()
    if orth > 1e-3:
        _fail(f"recon slice: camera rotations are not orthonormal ({orth})")
    print(f"[slice] launches per call {recon_launches}, of K2's {fa.launch_counts['flash_segment_attention_ws']} "
          f"warp-specialised; outputs finite, shapes {shapes}; "
          f"rotation orthonormality err {orth:.2e}")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipe.recon_from_frames(frames)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = recon_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[slice] 32 views 294x518 bf16: {ms:.1f} ms per call (median of {[round(t, 1) for t in times]}), "
          f"{32e3 / ms:.2f} frames/s, peak allocated {peak:.2f} GiB ({card})")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe.recon_from_frames(frames)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    del model, pipe, out
    torch.cuda.empty_cache()

    # ---- 7 + 8. the lse forwards and the backward kernels ---------------------
    train_batch, geo_start = train_torch.full_size_batch(cfg, TRAIN_VIEWS, TRAIN_HW, TRAIN_TOKENS, 0, dev)
    one = train_batch.map(lambda x: x[0])
    train_info = TokenInfo(one.doc_id, one.fn_id, one.noise_id, one.pos)
    real_tokens = int((one.doc_id >= 0).sum().item())

    def check_grads(tag, got, want, zero_rows=None):
        worst = 0.0
        for which, g, w in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(g).all():
                _fail(f"{tag}: {which} is not finite")
            max_rel, mean_rel, max_abs = _rel_errors(g, w)
            print(f"[bwd] {tag} {which}{tuple(g.shape)}: max|err|/max|ref| {max_rel:.3e} mean|err|/mean|ref| "
                  f"{mean_rel:.3e} max_abs_err {max_abs:.3e}")
            if max_rel > BWD_MAX_REL or mean_rel > BWD_MEAN_REL:
                _fail(f"{tag}: {which} disagrees with the plain backward (limits {BWD_MAX_REL}, {BWD_MEAN_REL})")
            if zero_rows is not None and (g[zero_rows] != 0).any():
                _fail(f"{tag}: {which} of rows that see nothing is not exactly 0")
            worst = max(worst, max_abs)
        return worst

    # a ragged pack (333 rows: no multiple of the 64-row tiles or the dkv kernel's 128-key blocks) and a
    # pack whose last two tiles are padding: whole rows and columns of SKIP tiles
    ragged_pack = make_token_info([200, 120], [80, 120, 50, 70], ["causal", "full", "causal", "full"],
                                  pad_to=333, device=dev)
    skip_pack = make_token_info([100, 156], [40, 60, 56, 100], ["causal", "full", "causal", "noise"],
                                pad_to=384, device=dev)
    skip_codes = fa.block_codes(skip_pack.packed(), skip_pack.packed())
    if not ((skip_codes == fa.BLOCK_SKIP).all(1).any() and (skip_codes == fa.BLOCK_SKIP).all(0).any()):
        _fail("the SKIP case has no whole row and column of SKIP tiles")
    def check_repeatable(tag, first, second):
        """Two launches on the same inputs give bitwise equal dq, dk and dv (no atomics)."""
        for which, x, y in zip(("dq", "dk", "dv"), first, second):
            if not torch.equal(x, y):
                _fail(f"{tag}: two launches gave different {which}")
        print(f"[bwd] {tag}: two launches bitwise equal")

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    # phase 16 is the last case: the ViT's training shape, 8 images of 2,916 patch rows each an
    # attention segment, 16:16 heads of 80 (the joint step's shape, phase 17)
    vit_seg = torch.arange(VIT_TRAIN_IMAGES, device=dev, dtype=torch.int32).repeat_interleave(VIT_ROWS_PER_IMAGE)
    vit_train_info = TokenInfo(vit_seg, vit_seg, torch.full_like(vit_seg, -1),
                               torch.arange(len(vit_seg), device=dev, dtype=torch.int32))
    for tag, info, h, kvh, d, iters in (
        ("train_pack_16_views", train_info, 12, 2, 128, 5),
        ("mixed_docs_padded", mixed, 12, 2, 128, 20),
        ("ragged_333_rows", ragged_pack, 12, 2, 128, 20),
        ("skip_rows_and_columns", skip_pack, 6, 2, 96, 20),
        ("vit_train_8_images_d80", vit_train_info, 16, 16, 80, 3),
    ):
        n = info.seq_len
        q, k, v, dout = rnd(n, h, d), rnd(n, kvh, d), rnd(n, kvh, d), rnd(n, h, d)
        meta = info.packed()
        codes = fa.block_codes(meta, meta)
        pad = info.doc_id < 0
        # K3: out equal to K2, lse against the plain version
        _, plain_lse = fa.flash_segment_attention_lse_reference(q.float(), k.float(), v.float(), info, info)
        out, lse = fa._segment_forward_cuda(q, k, v, meta, meta, codes, None, with_lse=True)
        if not torch.equal(out, fa.flash_segment_attention(q, k, v, info, info)):
            _fail(f"K3 {tag}: out differs from K2's")
        lse_err = (lse - plain_lse).abs().max().item()
        if lse_err > LSE_MAX_ABS or (pad.any() and not (lse[:, pad] == fa.LSE_EMPTY).all()):
            _fail(f"K3 {tag}: lse off by {lse_err} (limit {LSE_MAX_ABS}) or padding rows not LSE_EMPTY")
        out2, lse2 = fa._segment_forward_cuda(q, k, v, meta, meta, codes, None, with_lse=True)
        if not (torch.equal(out2, out) and torch.equal(lse2, lse)):
            _fail(f"K3 {tag}: two launches gave different out or lse")
        del out2, lse2
        ms3, plain3 = _timed_in_turns(
            lambda: fa._segment_forward_cuda(q, k, v, meta, meta, codes, None, with_lse=True),
            lambda: fa.flash_segment_attention_lse_reference(q.float(), k.float(), v.float(), info, info), iters)
        pairs = visible_pairs(info)
        b3, by3 = _attention_bound(pairs, h, d, 2, n, n, kvh, 2, 2, stat_rows=n * h)
        lib_fwd, why = _library_ms(gqa_mask_call(q, k, v, info), iters)
        print(f"[K3] {tag} q{(n, h, d)} kv{(n, kvh, d)}: out == K2 bitwise, two launches bitwise equal, lse "
              f"max_abs_err {lse_err:.3e}, kernel {ms3:.3f} ms, bound {b3:.4f} ms by {by3} ({b3 / ms3 * 100:.1f}%), "
              f"plain {plain3:.3f} ms, library forward (enable_gqa, materialised mask) {lib_fwd} ms "
              f"{why or ''}{_ratio(ms3, lib_fwd)} ({card})")
        k3e["max_abs_err"] = max(k3e["max_abs_err"], lse_err)
        # K5: dq, dk, dv against the plain backward on the kernel's own out and lse
        got = fa._segment_backward_cuda(q, k, v, out, lse, dout, meta, meta, codes, None)
        want = fa.flash_segment_attention_bwd_reference(q.float(), k.float(), v.float(), out.float(), lse,
                                                        dout.float(), info, info)
        worst = check_grads(f"K5 {tag}", got, want, pad if pad.any() else None)
        check_repeatable(f"K5 {tag}", got, fa._segment_backward_cuda(q, k, v, out, lse, dout, meta, meta, codes, None))
        k5q["max_abs_err"] = max(k5q["max_abs_err"], worst)
        k5kv["max_abs_err"] = max(k5kv["max_abs_err"], worst)
        del got, want, plain_lse
        if tag in ("train_pack_16_views", "vit_train_8_images_d80"):
            def run(which):
                return fa._segment_backward_cuda(q, k, v, out, lse, dout, meta, meta, codes, None, which=which)

            def plain_bwd():
                return fa.flash_segment_attention_bwd_reference(
                    q.float(), k.float(), v.float(), out.float(), lse, dout.float(), info, info)

            ms_dq, plain5 = _timed_in_turns(lambda: run(("dq",)), plain_bwd, 3)
            ms_dkv = _time_ms(lambda: run(("dkv",)), iters)
            ms_both = _time_ms(lambda: run(("dq", "dkv")), iters)
            fb, fby = _attention_bound(pairs, h, d, 5, n, n, kvh, 4, 4, stat_rows=n * h)
            bq, byq = _attention_bound(pairs, h, d, 3, n, n, kvh, 3, 2, stat_rows=2 * n * h)
            bkv, bykv = _attention_bound(pairs, h, d, 4, n, n, kvh, 2, 4, stat_rows=2 * n * h)
            lib_bwd, why_bwd = None, None
            try:
                mask = make_segment_mask(info, info)
                ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
                lib_out = sdpa(ql, kl, vl, attn_mask=mask, enable_gqa=True)
                lib_dout = dout.transpose(0, 1)[None]
                lib_bwd, why_bwd = _library_ms(
                    lambda: torch.autograd.grad(lib_out, (ql, kl, vl), lib_dout, retain_graph=True), 3)
                del lib_out, mask, ql, kl, vl
            except (RuntimeError, TypeError) as e:
                why_bwd = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
            shape = f"({n},{h}:{kvh},{d})"
            both = dict(dq_dk_dv_ms=ms_both, function_bound_ms=fb, function_bound_by=fby,
                        bound_counts="ms / bound_ms: this kernel alone and its own products (dq 3, dkv 4); "
                                     "dq_dk_dv_ms / function_bound_ms: both kernels and the 5 products the "
                                     "function needs", plain_and_library_cover="dq+dk+dv")
            rows = (
                (k3e, dict(ms=ms3, plain_ms=plain3, bound_ms=b3, bound_by=by3, library_ms=lib_fwd, shape=shape)),
                (k5q, dict(ms=ms_dq, plain_ms=plain5, bound_ms=bq, bound_by=byq, library_ms=lib_bwd, shape=shape,
                           **both)),
                (k5kv, dict(ms=ms_dkv, plain_ms=plain5, bound_ms=bkv, bound_by=bykv, library_ms=lib_bwd,
                            shape=shape, **both)),
            )
            for e, row in rows:  # the decoder's shape heads the entry; each shape also under "at"
                e.setdefault("at", {})[tag] = row
                if tag == "train_pack_16_views":
                    e.update(row)
            blocks = fa.bwd_blocks(n, n, h, kvh, 1, fa.dkv_head_split(n, n, h, kvh, 1, n_sm))
            print(f"[K5] {tag}: dq kernel {ms_dq:.3f} ms (its bound {bq:.3f} by {byq}), dkv kernel {ms_dkv:.3f} ms "
                  f"(its bound {bkv:.3f} by {bykv}), dq+dk+dv {ms_both:.3f} ms against the function's bound "
                  f"{fb:.3f} ms by {fby} ({fb / ms_both * 100:.1f}%); blocks dq {blocks[0]}, dkv {blocks[1]} on "
                  f"{n_sm} SMs; plain backward (dq+dk+dv) {plain5:.3f} ms; K3 bound {b3:.3f} ms; "
                  f"library forward {lib_fwd} ms {why or ''}, library backward (dq+dk+dv) {lib_bwd} ms "
                  f"{why_bwd or ''} ({card})")
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()

    b = TRAIN_VIEWS
    for tag, s, m, h, d, valid, cross in (
        ("dinov2", 782, 782, 16, 64, None, False),
        ("pi3_self", 777, 777, 16, 96, None, False),
        ("pi3_cross_frame0", 777, 777, 16, 96, None, True),
        ("pi3_self_valid_kv", 777, 777, 16, 96, 700, False),
    ):
        kb = 1 if cross else b
        q, dout = rnd(b, s, h, d), rnd(b, s, h, d)
        k0, v0_ = rnd(kb, m, h, d), rnd(kb, m, h, d)
        k, v = k0.expand(b, m, h, d), v0_.expand(b, m, h, d)
        out, lse = fa._batched_forward_cuda(q, k, v, valid, None, with_lse=True)
        if not torch.equal(out, fa.flash_batched_attention(q, k, v, valid_kv=valid)):
            _fail(f"K6 {tag}: out differs from K1's")
        _, plain_lse = fa.flash_batched_attention_lse_reference(q.float(), k.float(), v.float(), valid)
        lse_err = (lse - plain_lse).abs().max().item()
        if lse_err > LSE_MAX_ABS:
            _fail(f"K6 {tag}: lse off by {lse_err} (limit {LSE_MAX_ABS})")
        out2, lse2 = fa._batched_forward_cuda(q, k, v, valid, None, with_lse=True)
        if not (torch.equal(out2, out) and torch.equal(lse2, lse)):
            _fail(f"K6 {tag}: two launches gave different out or lse")
        del out2, lse2
        ms6, plain6 = _timed_in_turns(
            lambda: fa._batched_forward_cuda(q, k, v, valid, None, with_lse=True),
            lambda: fa.flash_batched_attention_lse_reference(q.float(), k.float(), v.float(), valid), 20)
        lib6, why6 = _library_ms(lambda: sdpa(q, _keys_that_count(k, valid), _keys_that_count(v, valid)), 20)
        b6, by6 = _batched_bound(b, s, m, kb, h, d, valid, lse=True)
        k6e.setdefault("at", {})[tag] = dict(shape=f"q({b},{s},{h},{d}) kv({kb},{m},{h},{d}) valid_kv={valid}",
                                             ms=ms6, plain_ms=plain6, bound_ms=b6, bound_by=by6, library_ms=lib6)
        print(f"[K6] {tag} q{(b, s, h, d)} kv{(kb, m, h, d)} valid_kv={valid}: out == K1 bitwise, two launches "
              f"bitwise equal, lse max_abs_err {lse_err:.3e}, kernel {ms6:.3f} ms plain {plain6:.3f} ms; bound "
              f"{b6:.4f} ms by {by6} ({b6 / ms6 * 100:.1f}%); library scaled_dot_product_attention {lib6} ms "
              f"{why6 or ''} ({card})")
        k6e["max_abs_err"] = max(k6e["max_abs_err"], lse_err)
        got = fa._batched_backward_cuda(q, k, v, out, lse, dout, valid, None)
        want = fa.flash_batched_attention_bwd_reference(q.float(), k.float(), v.float(), out.float(), lse,
                                                        dout.float(), valid)
        if cross:  # through the autograd.Function: the frame-0 gradient is the sum over the batch
            q_, k_, v_ = (t.clone().requires_grad_(True) for t in (q, k0, v0_))
            o_ = fa.flash_batched_attention(q_, k_.expand(b, m, h, d), v_.expand(b, m, h, d))
            got = torch.autograd.grad(o_, (q_, k_, v_), dout)
            want = (want[0], want[1].sum(0, keepdim=True), want[2].sum(0, keepdim=True))
        worst = check_grads(f"K7 {tag}", got, want)
        if not cross:
            check_repeatable(f"K7 {tag}", got, fa._batched_backward_cuda(q, k, v, out, lse, dout, valid, None))
        if valid is not None and ((got[1][:, valid:] != 0).any() or (got[2][:, valid:] != 0).any()):
            _fail(f"K7 {tag}: dk / dv of keys >= valid_kv are not exactly 0")
        k7q["max_abs_err"] = max(k7q["max_abs_err"], worst)
        k7kv["max_abs_err"] = max(k7kv["max_abs_err"], worst)
        del got, want

        def run(which):
            return fa._batched_backward_cuda(q, k, v, out, lse, dout, valid, None, which=which)

        if tag == "dinov2":
            def plain_bwd():
                return fa.flash_batched_attention_bwd_reference(
                    q.float(), k.float(), v.float(), out.float(), lse, dout.float(), valid)

            ms_dq, plain7 = _timed_in_turns(lambda: run(("dq",)), plain_bwd, 20)
            ms_dkv = _time_ms(lambda: run(("dkv",)), 20)
            ms_both = _time_ms(lambda: run(("dq", "dkv")), 20)
            pairs = b * s * m
            fb, fby = _attention_bound(pairs, h, d, 5, b * s, b * m, h, 4, 4, stat_rows=b * s * h)
            bq, byq = _attention_bound(pairs, h, d, 3, b * s, b * m, h, 3, 2, stat_rows=2 * b * s * h)
            bkv, bykv = _attention_bound(pairs, h, d, 4, b * s, b * m, h, 2, 4, stat_rows=2 * b * s * h)
            ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
            lib_out = sdpa(ql, kl, vl)
            lib_dout = dout.transpose(1, 2)
            lib_bwd, why_bwd = _library_ms(
                lambda: torch.autograd.grad(lib_out, (ql, kl, vl), lib_dout, retain_graph=True), 20)
            shape = f"({b},{s},{h},{d})"
            k6e.update(ms=ms6, plain_ms=plain6, bound_ms=b6, bound_by=by6, library_ms=lib6, shape=shape)
            both = dict(dq_dk_dv_ms=ms_both, function_bound_ms=fb, function_bound_by=fby,
                        bound_counts=k5q["bound_counts"], plain_and_library_cover="dq+dk+dv")
            k7q.update(ms=ms_dq, plain_ms=plain7, bound_ms=bq, bound_by=byq, library_ms=lib_bwd, shape=shape, **both)
            k7kv.update(ms=ms_dkv, plain_ms=plain7, bound_ms=bkv, bound_by=bykv, library_ms=lib_bwd, shape=shape,
                        **both)
            print(f"[K7] {tag}: dq kernel {ms_dq:.3f} ms (its bound {bq:.4f} by {byq}), dkv kernel {ms_dkv:.3f} ms "
                  f"(its bound {bkv:.4f} by {bykv}), dq+dk+dv {ms_both:.3f} ms against the function's bound "
                  f"{fb:.4f} ms by {fby} ({fb / ms_both * 100:.1f}%); "
                  f"plain backward (dq+dk+dv) {plain7:.3f} ms; "
                  f"library backward (dq+dk+dv) {lib_bwd} ms "
                  f"{why_bwd or ''} ({card})")
            del lib_out, ql, kl, vl
        elif tag == "pi3_self":
            print(f"[K7] {tag}: dq kernel {_time_ms(lambda: run(('dq',)), 20):.3f} ms, dkv kernel "
                  f"{_time_ms(lambda: run(('dkv',)), 20):.3f} ms, dq+dk+dv "
                  f"{_time_ms(lambda: run(('dq', 'dkv')), 20):.3f} ms ({card})")
    del q, k, v, k0, v0_, dout, out, lse
    torch.cuda.empty_cache()

    # ---- 9. train parity: card (fp32 masters, bf16 compute, kernels) vs CPU (fp32, plain) ----
    def grad_norms(m):
        groups = {"dino": "dino_model.", "llm": "language_model.", "point": ("point_decoder.", "point_head."),
                  "camera": ("camera_decoder.", "camera_head."),
                  "global": ("global_points_decoder.", "global_point_head."), "dino2llm": "dino2llm."}
        sq = {g: 0.0 for g in groups}
        for pname, p in m.named_parameters():
            if p.grad is not None:
                for g, prefix in groups.items():
                    if pname.startswith(prefix):
                        sq[g] += p.grad.float().square().sum().item()
        sq["all"] = sum(sq.values())
        return {g: val ** 0.5 for g, val in sq.items()}

    cut_batch, cut_geo_start = train_torch.full_size_batch(cut, 2, TRAIN_HW, 1792, 1, "cpu")
    cpu_model.train()
    trainer.apply_freeze(cpu_model, freeze_und=True)
    t0 = time.perf_counter()
    want_loss, _ = trainer.train_forward(cpu_model, cut_batch.map(lambda x: x[0]), cut,
                                         compute_dtype=torch.float32, geo_start=cut_geo_start)
    want_loss.backward()
    cpu_s = time.perf_counter() - t0
    want_norms = grad_norms(cpu_model)
    gpu_model = build_model(cut, device=dev, dtype=torch.float32, seed=None).train()
    gpu_model.load_state_dict(cpu_model.state_dict())
    trainer.apply_freeze(gpu_model, freeze_und=True)
    n_views = cut_batch.dino_images.shape[1]
    # the step as train_torch.py runs it, then with groups of two layers checkpointed around the
    # per-layer checkpoints, and with the Pi3 heads run one view at a time: neither changes the
    # function (tests/test_torch_trainer.py holds them to 1e-6 and 1e-4 of it on the CPU), so all
    # three are held against the one CPU run
    for tag, kw, want_launches in (
        ("per-layer checkpoints", {}, _step_launches(cut)),
        ("remat_group=2", dict(remat_group=2, dino_remat_group=2),
         _step_launches(cut, remat_group=2, dino_remat_group=2)),
        ("head_view_chunk=1", dict(head_view_chunk=1), _step_launches(cut, chunks=n_views)),
    ):
        gpu_model.zero_grad(set_to_none=True)
        fa.reset_launch_counts()
        got_loss, _ = trainer.train_forward(gpu_model, cut_batch.map(lambda x: x[0].to(dev)), cut,
                                            compute_dtype=torch.bfloat16, geo_start=cut_geo_start, **kw)
        got_loss.backward()
        torch.cuda.synchronize()
        launches = _launches(fa)
        if launches != want_launches:
            _fail(f"train parity {tag}: launches {launches}, expected {want_launches}")
        rel = abs(got_loss.item() - want_loss.item()) / abs(want_loss.item())
        print(f"[train-parity] {tag}: loss card {got_loss.item():.5f} cpu {want_loss.item():.5f} rel {rel:.3e} "
              f"(budget 3e-2); cpu fp32 forward+backward {cpu_s:.1f} s; launches {launches}")
        if not rel <= 3e-2:
            _fail(f"train parity {tag}: loss off by {rel} (budget 3e-2)")
        got_norms = grad_norms(gpu_model)
        for g, w in want_norms.items():
            r = abs(got_norms[g] - w) / w
            print(f"[train-parity] {tag}: grad norm {g}: card {got_norms[g]:.4e} cpu {w:.4e} rel {r:.3e} "
                  f"(budget 1e-1)")
            if not r <= 1e-1:
                _fail(f"train parity {tag}: grad norm of {g} off by {r} (budget 1e-1)")
    del cpu_model, gpu_model, got_loss, want_loss
    torch.cuda.empty_cache()

    # ---- 10. the training slice -------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.float32, seed=0).train()
    optimizer = trainer.make_optimizer(
        model, schedule=trainer.warmup_cosine_schedule(0.0, 1e-4, 0, 1000), weight_decay=0.05,
        freeze_und=True, mu_dtype=torch.bfloat16, factored_v=True)
    state = trainer.init_train_state(model, optimizer, ema=True)
    step_fn = trainer.make_train_step(cfg, compute_dtype=torch.bfloat16, ema_decay=0.9999, geo_start=geo_start)
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in optimizer.params)
    print(f"[train] fp32 init of {n_params / 1e9:.3f} B parameters ({n_train / 1e9:.3f} B trainable), optimizer "
          f"and EMA on the card in {time.perf_counter() - t0:.1f} s; pack {TRAIN_TOKENS} rows, {real_tokens} real "
          f"tokens, {TRAIN_VIEWS} views of {TRAIN_HW[0]}x{TRAIN_HW[1]}, geo_start {geo_start}")
    train_launches = _full_size_steps(
        env, "train", state, step_fn, train_batch, real_tokens, _step_launches(cfg),
        f"{TRAIN_VIEWS} views {TRAIN_HW[0]}x{TRAIN_HW[1]}, {TRAIN_TOKENS}-row pack, bf16 compute, fp32 masters")
    del model, optimizer, state, step_fn, train_batch
    torch.cuda.empty_cache()
    return recon_launches, train_launches, recon_ms


class _StepChecks:
    """What every full-size training step of the smoke is held to. Built before the first step: copies
    a sample of the frozen parameters (and every parameter and buffer whose name starts with one of
    `always_frozen`) and of the trainable ones. `step` runs one step, its launches held to the count
    derived for its batch and its loss and gradient norm finite; `frozen_unchanged` holds the frozen
    copies and their EMA bitwise; `moved` counts the sampled trainable leaves and EMA leaves that
    changed."""

    def __init__(self, tag, state, always_frozen=()):
        from g2vlm_tpu_torch.parallel.comm import local

        model = state.model
        self.tag = tag
        named = dict(model.named_parameters())
        frozen_names = [n_ for n_, p in named.items() if not p.requires_grad]
        # the local shards of a sharded model's parameters (views: the steps' updates show in them)
        self.named = {n_: local(p.detach()) for n_, p in named.items()}
        self.ema = {n_: local(e) for n_, e in state.ema_params.items()}
        self.probe = frozen_names[:: max(1, len(frozen_names) // 8)]
        self.probe += [n_ for n_ in frozen_names if n_.startswith(always_frozen) and n_ not in self.probe]
        self.buffers = {n_: b.detach().clone() for n_, b in model.named_buffers() if n_.startswith(always_frozen)}
        self.before = {n_: self.named[n_].detach().clone() for n_ in self.probe}
        self.moved_probe = {n_: self.named[n_].clone() for n_, p in named.items()
                            if p.requires_grad and p.numel() < 5_000_000}
        self.total = {}  # launches summed over the steps

    def step(self, step_fn, state, batch, want_launches):
        """Returns (state, metrics, ms)."""
        import numpy as np
        import torch

        from g2vlm_tpu_torch.ops import flash_attention as fa

        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _launches(fa)
        if launches != want_launches:
            _fail(f"{self.tag} step: launches {launches}, expected {want_launches}")
        for k, v in launches.items():
            self.total[k] = self.total.get(k, 0) + v
        if not (np.isfinite(metrics["loss"].item()) and np.isfinite(metrics["grad_norm"].item())):
            _fail(f"{self.tag} step: loss {metrics['loss'].item()} grad_norm {metrics['grad_norm'].item()}")
        return state, metrics, ms

    def frozen_unchanged(self, state):
        import torch

        for n_ in self.probe:
            if not torch.equal(self.named[n_], self.before[n_]) or not torch.equal(self.ema[n_], self.before[n_]):
                _fail(f"{self.tag}: frozen parameter {n_} or its EMA changed")
        for n_, b in state.model.named_buffers():
            if n_ in self.buffers and not torch.equal(b, self.buffers[n_]):
                _fail(f"{self.tag}: frozen buffer {n_} changed")

    def moved(self, state):
        import torch

        return (sum(not torch.equal(self.named[n_], old) for n_, old in self.moved_probe.items()),
                sum(not torch.equal(self.ema[n_], old) for n_, old in self.moved_probe.items()))


def _full_size_steps(env, tag, state, step_fn, batch, real_tokens, want_launches, desc, always_frozen=()):
    """Four steps on one repeated batch, held by _StepChecks; the loss must fall over three steps, and
    at least 90% of a sample of the trainable parameters and of their EMA move. Prints each step and ms
    per step (median of steps 1-3), real tokens/s and peak memory; returns the launches of the last
    step."""
    import torch

    checks = _StepChecks(tag, state, always_frozen)
    losses, times = [], []
    # step 0's memory split: the peak up to the optimizer's update (forward and backward), and in it
    opt, split = state.optimizer, {}

    def update_with_peaks(update=opt.step):
        split["through_backward"] = torch.cuda.max_memory_allocated()
        split["held_before_update"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = update()
        split["in_update"] = torch.cuda.max_memory_allocated()
        return out

    for step in range(4):
        if step == 0:
            opt.step = update_with_peaks
        state, metrics, ms = checks.step(step_fn, state, batch, want_launches)
        if step == 0:
            del opt.step
        times.append(ms)
        losses.append(metrics["loss"].item())
        print(f"[{tag}] step {step}: loss {losses[-1]:.5f} "
              + " ".join(f"{k} {val.item():.4f}" for k, val in metrics.items() if k != "loss")
              + f" | {times[-1]:.1f} ms")
    if not losses[2] < losses[0]:
        _fail(f"{tag}: the loss did not fall over three steps on one batch: {losses}")
    checks.frozen_unchanged(state)
    n_moved, n_ema_moved = checks.moved(state)
    n_probe = len(checks.moved_probe)
    if n_moved < 0.9 * n_probe or n_ema_moved < 0.9 * n_probe:
        _fail(f"{tag}: only {n_moved} parameters and {n_ema_moved} EMA leaves of {n_probe} changed")
    ms = statistics.median(times[1:])
    peak = max(torch.cuda.max_memory_allocated(), split["through_backward"]) / 2**30
    env.steps[tag] = dict(losses=losses, ms=ms, tokens_per_s=real_tokens / ms * 1e3, peak_gib=peak)
    print(f"[{tag}] memory of step 0: peak through the backward {split['through_backward'] / 2**30:.2f} GiB, "
          f"held at the update {split['held_before_update'] / 2**30:.2f} GiB, peak in the update "
          f"{split['in_update'] / 2**30:.2f} GiB; state reckoned by tests/check_open_items.py conf_state")
    print(f"[{tag}] {desc}: {ms:.1f} ms per step (median of steps 1.. of {[round(t, 1) for t in times]}), "
          f"{real_tokens / ms * 1e3:.1f} real tokens/s, peak allocated {peak:.2f} GiB; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; {len(checks.probe)} frozen leaves (a sample, and all under {always_frozen}) and "
          f"their EMA bitwise unchanged, {len(checks.buffers)} frozen buffers unchanged, {n_moved}/{n_probe} "
          f"sampled trainable leaves changed; launches per step {want_launches} ({env.card})")

    if env.args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step_fn(state, batch)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))
    return dict(want_launches)



QUESTION = "The red point and the blue point mark two positions. Which one is closer to the camera?"
FOLLOW_UP = "And which one is further to the left?"


def _round_robin_ms(fns, iters: int):
    """Each of `fns` (name -> callable) warm, then timed in turns, once
    forwards and once backwards through the list; returns name -> mean ms."""
    for fn in fns.values():
        fn()
    names = list(fns)
    total = {n: 0.0 for n in names}
    for order in (names, names[::-1]):
        for n in order:
            total[n] += _time_ms(fns[n], iters)
    return {n: t / 2 for n, t in total.items()}


def _chat_phases(env, recon_ms):
    """Phases 11-14. Returns the kernels' launches of the three chat calls
    (default, int8, pipelined), each read around one call."""
    import gc

    import numpy as np
    import torch

    from g2vlm_tpu_torch.config import G2VLMConfig, cut_depth_config
    from g2vlm_tpu_torch.data.device_preprocess import vit_device_grid
    from g2vlm_tpu_torch.inference import decoding
    from g2vlm_tpu_torch.inference.pipeline import UPLOAD_CHUNKS, G2VLMPipeline
    from g2vlm_tpu_torch.models.g2vlm import split_order
    from g2vlm_tpu_torch.ops import decode_fused as df
    from g2vlm_tpu_torch.ops import flash_attention as fa
    from g2vlm_tpu_torch.ops.masks import TokenInfo, make_token_info
    from g2vlm_tpu_torch.weights import build_model

    args, dev, card, gen, rnd = env.args, env.dev, env.card, env.gen, env.rnd
    entry_for, gqa_mask_call = env.entry_for, env.gqa_mask_call
    visible_pairs, live_pairs = env.visible_pairs, env.live_pairs
    K1, K2 = "flash_batched_attention", "flash_segment_attention"
    K4, K8 = "flash_segment_attention_pipe", "flash_segment_attention_int8"
    k2e = entry_for(K2, "g2vlm_tpu/ops/flash_attention.py:168")
    k4e = entry_for(K4, "g2vlm_tpu/ops/flash_attention.py:270")
    k8e = entry_for(K8, "g2vlm_tpu/ops/flash_attention.py:494")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 11. K2 at head dim 80, K4 and K8 against their plain versions ---------------
    cfg = G2VLMConfig()
    n_views = 32
    grid = vit_device_grid()
    per_image = int(np.prod(grid))
    pre = G2VLMPipeline(None, cfg).build_chat_prefill(n_views, 21, 37, [grid] * n_views, QUESTION)
    perm, geo_start = split_order(pre)  # the kernel sees the rows sorted [und | geo | padding]
    perm_t = torch.as_tensor(perm, device=dev)
    chat_info = TokenInfo(*(f[perm_t] for f in pre.token_info(dev)))
    seg = torch.arange(4, device=dev, dtype=torch.int32).repeat_interleave(per_image)
    vit_info = TokenInfo(seg, seg, torch.full_like(seg, -1), torch.arange(len(seg), device=dev, dtype=torch.int32))
    ragged = make_token_info([100, 156], [40, 60, 56, 100], ["causal", "full", "causal", "noise"],
                             pad_to=300, device=dev)
    print(f"[K2/K4/K8] chat prefill: {pre.seq_len} rows padded to {len(pre.doc_id)} ({len(pre.dino_indexes)} dino, "
          f"{len(pre.vit_indexes)} ViT, {len(pre.text_indexes)} text), geo_start {geo_start}; ViT chunk "
          f"{len(seg)} rows = 4 images of {per_image}")

    def int8_bound(pairs, h, d, tensors):
        """QK^T at the int8 tensor-core rate, P.V at the bf16 rate; every operand once."""
        t_ops = (2.0 * pairs * d * h / PEAK_INT8_OPS + 2.0 * pairs * d * h / PEAK_BF16_FLOPS) * 1e3
        t_bytes = sum(t.numel() * t.element_size() for t in tensors) / PEAK_BYTES_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")

    def check_forward(tag, got, want, pad):
        err = (got.float() - want.float()).abs()
        mx, mean = err.max().item(), err.mean().item()
        if not torch.isfinite(got).all() or mx > FWD_MAX_ABS or mean > FWD_MEAN_ABS:
            _fail(f"{tag} disagrees with its plain version (max {mx}, mean {mean}; limits {FWD_MAX_ABS}, "
                  f"{FWD_MEAN_ABS})")
        if pad.any() and (got[pad] != 0).any():
            _fail(f"{tag}: rows that see no key are not exactly 0")
        return mx, mean

    for tag, info, h, kvh, d, iters in (
        ("chat_prefill_32_views", chat_info, 12, 2, 128, 2),
        ("vit_chunk_4_images", vit_info, 16, 16, 80, 10),
        ("mixed_docs_ragged", ragged, 12, 2, 128, 20),
    ):
        n = info.seq_len
        pad = info.doc_id < 0
        q, k, v = rnd(n, h, d), rnd(n, kvh, d), rnd(n, kvh, d)
        plan = fa.segment_plan(info, info)  # made once per forward on the main path
        meta, _, codes = plan
        q8, qs, k8, ks = fa.quantize_qk(q, k, meta)

        def plain():
            return fa.flash_segment_attention_reference(q.float(), k.float(), v.float(), info, info)

        def plain8():
            return fa._int8_attention_plain(q8, qs, k8, ks, v.float(), info, info)

        runs = {
            "K2": lambda: fa.flash_segment_attention(q, k, v, info, info, plan=plan),
            "K4": lambda: fa.flash_segment_attention(q, k, v, info, info, pipelined=True, plan=plan),
            "K8": lambda: fa._int8_forward_cuda(q8, qs, k8, ks, v, *plan),
            "K8+quantiser": lambda: fa.flash_segment_attention_int8(q, k, v, info, info, plan=plan),
            "plan": lambda: fa.segment_plan(info, info),
        }
        want = plain()
        got2, got4, got8 = runs["K2"](), runs["K4"](), runs["K8+quantiser"]()
        torch.cuda.synchronize()
        mx2, mean2 = check_forward(f"K2 {tag}", got2, want, pad)
        mx4, mean4 = check_forward(f"K4 {tag}", got4, want, pad)
        # K4 does K2's arithmetic on K2's values in K2's order; the compiler may still contract a
        # multiply and a subtract differently in the two kernels, so equality is to rounding
        d42 = (got4.float() - got2.float()).abs().max().item()
        if d42 > 1e-3:
            _fail(f"K4 {tag}: differs from K2 by {d42} (limit 1e-3)")
        if not (torch.equal(got2, runs["K2"]()) and torch.equal(got4, runs["K4"]())):
            _fail(f"K2 / K4 {tag}: two launches gave different outputs")
        want8 = plain8()
        mx8, mean8 = check_forward(f"K8 {tag}", got8, want8, pad)
        first8 = runs["K8"]()
        if not (torch.equal(got8, first8) and torch.equal(first8, runs["K8"]())):
            _fail(f"K8 {tag}: two launches on the wrapper's own quantised operands gave different outputs")
        del first8
        quant_rel = ((got8.float() - want.float()).abs().max() / want.float().abs().max()).item()
        del want8, got2, got4, got8
        ms = _round_robin_ms(runs, iters)
        plain_ms = _round_robin_ms({"plain": plain, "plain8": plain8}, 1)
        pairs, tile_pairs = visible_pairs(info), live_pairs(info)
        bound_ms, by = _attention_bound(pairs, h, d, 2, n, n, kvh, 2, 2)
        out = torch.empty_like(q)
        bound8, by8 = int8_bound(pairs, h, d, (q8, k8, v, out, qs, ks, meta, meta, codes))
        lib, why = _library_ms(gqa_mask_call(q, k, v, info), 3)
        shape = f"({n},{h}:{kvh},{d})"
        print(f"[K2/K4/K8] {tag} q{(n, h, d)} kv{(n, kvh, d)}, {pairs / 1e6:.1f} M visible pairs "
              f"(the bounds count these), {tile_pairs / 1e6:.1f} M pairs in the tiles the codes do not skip ({card}):")
        print(f"    K2 max_abs_err {mx2:.3e} mean {mean2:.3e}, {ms['K2']:.3f} ms ({bound_ms / ms['K2'] * 100:.1f}% of "
              f"the bound{_ratio(ms['K2'], lib)}) | K4 max_abs_err {mx4:.3e} mean {mean4:.3e}, max|K4-K2| {d42:.3e} "
              f"({'bitwise equal' if d42 == 0 else 'to rounding'}), {ms['K4']:.3f} ms ({bound_ms / ms['K4'] * 100:.1f}% "
              f"of the bound{_ratio(ms['K4'], lib)}) | K2 and K4 two launches bitwise equal | bound {bound_ms:.3f} ms "
              f"by {by} | plain {plain_ms['plain']:.3f} ms | library scaled_dot_product_attention (enable_gqa, "
              f"materialised mask) {lib} ms {why or ''}")
        if d == 80:
            print(f"    K2 at head dim 80: {ms['K2']:.3f} ms; the parent's mma.sync kernel took {PARENT_K2_D80_MS} ms "
                  f"on an H100 80GB HBM3 at 700 W (PERF.md), {ms['K2'] / PARENT_K2_D80_MS * 100:.1f}% of it ({card})")
        print(f"    K8 against its plain version max_abs_err {mx8:.3e} mean {mean8:.3e}, two launches bitwise equal; "
              f"against the unquantised plain version max|err|/max|ref| {quant_rel:.3e}; kernel {ms['K8']:.3f} ms "
              f"({bound8 / ms['K8'] * 100:.1f}% of its bound {bound8:.3f} ms by {by8}; {ms['K8'] / ms['K2']:.2f}x K2's "
              f"{ms['K2']:.3f} ms here), with the quantiser {ms['K8+quantiser']:.3f} ms | plain "
              f"{plain_ms['plain8']:.3f} ms | library: none")
        if tag in PARENT_K8_MS:
            print(f"    K8 here: {ms['K8']:.3f} ms; the parent's mma.sync kernel took {PARENT_K8_MS[tag]} ms on an H100 "
                  f"80GB HBM3 at 700 W (PERF.md), {ms['K8'] / PARENT_K8_MS[tag] * 100:.1f}% of it ({card})")
        print(f"    the plan (packed metadata and tile codes), made once per forward and not per launch: "
              f"{ms['plan']:.3f} ms")
        k2e["max_abs_err"] = max(k2e["max_abs_err"], mx2)
        k4e["max_abs_err"] = max(k4e["max_abs_err"], mx4)
        k8e["max_abs_err"] = max(k8e["max_abs_err"], mx8)
        at = {"chat_prefill_32_views": "", "vit_chunk_4_images": "_vit_chunk"}.get(tag)
        if at is not None:
            for e, key, p_ms, b_ms, b_by, lib_ms in ((k2e, "K2", plain_ms["plain"], bound_ms, by, lib),
                                                      (k4e, "K4", plain_ms["plain"], bound_ms, by, lib),
                                                      (k8e, "K8", plain_ms["plain8"], bound8, by8, None)):
                if e is k2e:  # K2's own line keeps the recon prefill of phase 4; these ride beside it
                    at_ = at or "_chat_prefill"
                    e.update({"ms" + at_: ms[key], "plain_ms" + at_: p_ms, "bound_ms" + at_: b_ms,
                              "library_ms" + at_: lib_ms, "shape" + at_: shape})
                else:
                    e.update({"ms" + at: ms[key], "plain_ms" + at: p_ms, "bound_ms" + at: b_ms,
                              "bound_by" + at: b_by, "library_ms" + at: lib_ms, "shape" + at: shape})
            k8e["ms_with_quantiser" + at] = ms["K8+quantiser"]
        del q, k, v, q8, k8, qs, ks, want, out
        torch.cuda.empty_cache()

    # K8 on an outlier channel (the Hadamard rotation spreads it), on keys with a common-mode
    # offset (the K mean removes it) and on logits of hundreds of nats
    info = make_token_info([256], [256], ["causal"], pad_to=300, device=dev)
    n, h, kvh, d = 300, 4, 2, 128
    q, k, v = rnd(n, h, d), rnd(n, kvh, d), rnd(n, kvh, d)
    q[:, :, 5] *= 20.0
    k = (k.float() + 8.0 * torch.randn(1, kvh, d, generator=gen, device=dev)).to(torch.bfloat16)
    want = fa.flash_segment_attention_reference(q.float(), k.float(), v.float(), info, info)
    rels = {}
    for tag, kw in (("hadamard+kmean", {}), ("neither", dict(hadamard=False, kmean=False))):
        got = fa.flash_segment_attention_int8(q, k, v, info, info, **kw)
        q8, qs, k8, ks = fa.quantize_qk(q, k, info.packed(), **kw)
        mx, _ = check_forward(f"K8 outliers {tag}", got, fa._int8_attention_plain(q8, qs, k8, ks, v.float(), info, info),
                              info.doc_id < 0)
        if not torch.equal(got, fa.flash_segment_attention_int8(q, k, v, info, info, **kw)):
            _fail(f"K8 outliers {tag}: two launches gave different outputs")
        k8e["max_abs_err"] = max(k8e["max_abs_err"], mx)
        rels[tag] = ((got.float() - want).abs().max() / want.abs().max()).item()
    v0 = torch.randn(d, generator=gen, device=dev)
    v0 /= v0.norm()
    q2, k2 = rnd(n, h, d), rnd(n, kvh, d)
    q2[7] = (60.0 * v0).to(torch.bfloat16)
    k2[3] = (60.0 * v0).to(torch.bfloat16)
    extreme = fa.flash_segment_attention_int8(q2, k2, v, info, info)
    if not torch.equal(extreme, fa.flash_segment_attention_int8(q2, k2, v, info, info)):
        _fail("K8 extreme logits: two launches gave different outputs")
    torch.cuda.synchronize()
    print(f"[K8] outlier channel + common-mode keys: against the unquantised plain version max|err|/max|ref| "
          f"{rels['hadamard+kmean']:.3e} with the Hadamard rotation and the K mean, {rels['neither']:.3e} with "
          f"neither; extreme logits finite {bool(torch.isfinite(extreme).all())}")
    if not rels["hadamard+kmean"] < min(rels["neither"], 5e-2) or not torch.isfinite(extreme).all():
        _fail("K8 outlier / extreme-logit case: the rotation and the K mean must cut the error, below 5e-2")
    del q, k, v, q2, k2, want, got, extreme

    # ---- 12. chat parity at cut depth: card bf16 (kernels) vs CPU fp32 (plain) --------
    cut = cut_depth_config(cfg, 2)
    token_ids = dict(bos_token_id=1, eos_token_id=2, start_of_image=3, end_of_image=4)
    frames8 = list(np.random.default_rng(1).integers(0, 256, (8, 294, 518, 3), dtype=np.uint8))

    def first_step(pipe, frames, n_new=8, device_preprocess=True, quantized=False):
        """Prefill hidden states of the real rows, the first decode step's logits (both on the
        CPU) and the first `n_new` greedy ids; the prefill as `chat(device_preprocess=...)` and
        the cache as `chat(quantized_kv=...)` make them."""
        prefill, hidden, kv, _, _ = pipe.chat_prefill(frames, QUESTION, device_preprocess=device_preprocess)
        dt, lm_ = pipe.model.dtype, pipe.model.language_model
        cache = decoding.build_cache(kv, prefill.seq_len, cut.llm, len(prefill.doc_id) + 128, dtype=dt,
                                     quantized=quantized)
        pos_ = int(prefill.next_rope_pos)
        logits, _ = decoding.decode_step(lm_, cache, pipe._start_token(), pos_, cut.llm, compute_dtype=dt)
        first = int(logits.argmax())
        toks, _, _ = decoding.generate(lm_, cache, first, pos_ + 1, -1, cut.llm, max_new_tokens=n_new - 1,
                                       compute_dtype=dt)
        real = torch.as_tensor(prefill.doc_id >= 0)
        return hidden.float().cpu()[real], logits.float().cpu(), [first] + toks.tolist()

    def batched_first_step(pipe, frames, prompts, n_new=8):
        """generate_batched on one sequence a prompt: the prompts' prefills (of different lengths)
        and their caches of one capacity, stacked with stack_caches. Returns the prefill hidden
        states of the real rows of each, the batched first step's logits (B, V) (on the CPU), the
        greedy ids of the batched loop (B lists), the prefills' launches, the decode's launches
        and the prefill lengths."""
        dt, lm_, dev_ = pipe.model.dtype, pipe.model.language_model, pipe.model.device
        fa.reset_launch_counts()
        pres = [pipe.chat_prefill(frames, p, device_preprocess=True) for p in prompts]
        prefill_launches = _launches(fa)
        cap = max(len(pre.doc_id) for pre, *_ in pres) + 128
        caches = decoding.stack_caches([decoding.build_cache(kv, pre.seq_len, cut.llm, cap, dtype=dt)
                                        for pre, _, kv, _, _ in pres])
        start = torch.full((len(prompts),), pipe._start_token(), dtype=torch.int64, device=dev_)
        pos_ = torch.as_tensor([int(pre.next_rope_pos) for pre, *_ in pres], dtype=torch.int64, device=dev_)
        fa.reset_launch_counts()
        with torch.inference_mode():
            logits = decoding._decode_step(lm_, caches, start, pos_, cut.llm, dt, lm_.rope_inv_freq(dev_))
        first = logits.argmax(-1)
        toks, _, _ = decoding.generate_batched(lm_, caches, first, pos_ + 1, -1, cut.llm, max_new_tokens=n_new - 1,
                                               compute_dtype=dt)
        decode_launches = _launches(fa)
        hidden = [h.float().cpu()[torch.as_tensor(pre.doc_id >= 0)] for pre, h, *_ in pres]
        ids = torch.cat([first[:, None], toks], 1).tolist()
        return hidden, logits.float().cpu(), ids, prefill_launches, decode_launches, [pre.seq_len for pre, *_ in pres]

    def check_ids(tag, ids):
        if not ids or not all(0 <= t < cut.llm.vocab_size for t in ids):
            _fail(f"chat parity {tag}: ids outside the vocabulary of {cut.llm.vocab_size}: {ids}")

    def distances(got, want):
        out = []
        for a, b in zip(got[:2], want[:2]):
            if not torch.isfinite(a).all():
                _fail("chat parity: non-finite prefill hidden states or logits")
            out.append(((a - b).abs().max() / b.abs().max()).item())
        return out

    cpu_model = build_model(cut, device="cpu", dtype=torch.float32, seed=0)
    t0 = time.perf_counter()
    cpu_pipe = G2VLMPipeline(cpu_model, cut, new_token_ids=token_ids)
    want = first_step(cpu_pipe, frames8[:2])
    # the paths that only these gates run on the card: the int8 KV cache, the host preprocess
    # (PIL resize on the CPU, then one upload), and two sequences in one batched decode loop
    want_paths = {"quantized_kv": first_step(cpu_pipe, frames8[:2], quantized=True),
                  "host_preprocess": first_step(cpu_pipe, frames8[:2], device_preprocess=False)}
    want_batched = batched_first_step(cpu_pipe, frames8[:2], [QUESTION, FOLLOW_UP])
    cpu_s = time.perf_counter() - t0
    gpu_model = build_model(cut, device=dev, dtype=torch.bfloat16, seed=None)
    gpu_model.load_state_dict(cpu_model.state_dict())
    del cpu_model, cpu_pipe
    n_vit, n_llm, n_dino = cut.vit.depth, cut.llm.num_hidden_layers, cut.dino.num_hidden_layers
    for tag, kw, want_launches in (
        ("default", {}, {K1: n_dino, K2: n_vit + n_llm}),
        ("attn_pipe", dict(attn_pipe=True), {K1: n_dino, K4: n_vit + n_llm}),
        # two views: the ViT's 5,832 rows are above the int8 size rule, the prefill's ~3,100 below it
        ("attn_impl=int8", dict(attn_impl="int8"), {K1: n_dino, K8: n_vit, K2: n_llm}),
    ):
        pipe = G2VLMPipeline(gpu_model, cut, new_token_ids=token_ids, **kw)
        fa.reset_launch_counts()
        got = first_step(pipe, frames8[:2])
        launches = _launches(fa)
        if launches != want_launches:
            _fail(f"chat parity {tag}: launches {launches}, expected {want_launches}")
        rel_h, rel_l = distances(got, want)
        same = sum(a == b for a, b in zip(got[2], want[2]))
        print(f"[chat-parity] {tag}, 2 views, {want[0].shape[0]} real rows: prefill hidden max|gpu-cpu|/max|cpu| "
              f"{rel_h:.3e}, first-step logits {rel_l:.3e} (budget 3e-2{', printed only' if 'int8' in tag else ''}); "
              f"{same} of {len(want[2])} greedy ids equal; launches {launches}")
        if "int8" not in tag and (rel_h > 3e-2 or rel_l > 3e-2):
            _fail(f"chat parity {tag}: hidden {rel_h}, logits {rel_l} (budget 3e-2)")

    # the int8 KV cache and the host preprocess: through the entry point (launches, ids), and the
    # prefill hidden states and first-step logits against the CPU's of the same path
    pipe = G2VLMPipeline(gpu_model, cut, new_token_ids=token_ids)
    for tag, kw in (("quantized_kv", dict(quantized_kv=True, device_preprocess=True)),
                    ("host_preprocess", dict(device_preprocess=False))):
        want_launches = {K1: n_dino, K2: n_vit + n_llm}
        fa.reset_launch_counts()
        _, info = pipe.chat(frames8[:2], QUESTION, max_new_tokens=8, return_info=True, **kw)
        launches = _launches(fa)
        check_ids(f"{tag} chat()", info["token_ids"])
        fa.reset_launch_counts()
        got = first_step(pipe, frames8[:2], device_preprocess=kw["device_preprocess"],
                         quantized=kw.get("quantized_kv", False))
        step_launches = _launches(fa)
        if launches != want_launches or step_launches != want_launches:
            _fail(f"chat parity {tag}: launches {launches} (chat) / {step_launches}, expected {want_launches}")
        check_ids(tag, got[2])
        rel_h, rel_l = distances(got, want_paths[tag])
        same = sum(a == b for a, b in zip(got[2], want_paths[tag][2]))
        print(f"[chat-parity] {tag}, 2 views: prefill hidden max|gpu-cpu|/max|cpu| {rel_h:.3e}, first-step logits "
              f"{rel_l:.3e} (budget 3e-2); {same} of {len(got[2])} greedy ids equal the CPU's; chat() ids "
              f"{info['token_ids']} in the vocabulary; launches {launches} per call")
        if rel_h > 3e-2 or rel_l > 3e-2:
            _fail(f"chat parity {tag}: hidden {rel_h}, logits {rel_l} (budget 3e-2)")

    # generate_batched: two sequences of different lengths in one decode loop
    hidden_b, logits_b, ids_b, pre_launches, dec_launches, lens = batched_first_step(
        pipe, frames8[:2], [QUESTION, FOLLOW_UP])
    if pre_launches != {K1: 2 * n_dino, K2: 2 * (n_vit + n_llm)} or dec_launches:
        _fail(f"chat parity generate_batched: prefill launches {pre_launches}, decode launches {dec_launches}")
    if len(set(lens)) != 2:
        _fail(f"chat parity generate_batched: the prompts' prefills have one length {lens}")
    rel_hb = max(distances((a, logits_b), (b, want_batched[1]))[0] for a, b in zip(hidden_b, want_batched[0]))
    rel_lb = distances((hidden_b[0], logits_b), (want_batched[0][0], want_batched[1]))[1]
    for i, row in enumerate(ids_b):
        check_ids(f"generate_batched sequence {i}", row)
    same = [sum(a == b for a, b in zip(g, w)) for g, w in zip(ids_b, want_batched[2])]
    print(f"[chat-parity] generate_batched, 2 sequences of {lens} prefill rows: prefill hidden {rel_hb:.3e}, batched "
          f"first-step logits {rel_lb:.3e} (budget 3e-2); greedy ids equal the CPU's {same} of {len(ids_b[0])}, all in "
          f"the vocabulary; launches: prefills {pre_launches}, decode loop none")
    if rel_hb > 3e-2 or rel_lb > 3e-2:
        _fail(f"chat parity generate_batched: hidden {rel_hb}, logits {rel_lb} (budget 3e-2)")
    # eight views: the prefill's ~12,200 rows are above the rule too; int8 against the default kernels
    base = first_step(G2VLMPipeline(gpu_model, cut, new_token_ids=token_ids), frames8)
    fa.reset_launch_counts()
    got = first_step(G2VLMPipeline(gpu_model, cut, new_token_ids=token_ids, attn_impl="int8"), frames8)
    launches = _launches(fa)
    if launches != {K1: 4 * n_dino, K8: 4 * n_vit + n_llm}:  # both towers once per chunk of two views
        _fail(f"chat parity int8, 8 views: launches {launches}")
    rel_h, rel_l = distances(got, base)
    print(f"[chat-parity] attn_impl=int8 against the default kernels on the card, 8 views, {base[0].shape[0]} real "
          f"rows: prefill hidden {rel_h:.3e}, first-step logits {rel_l:.3e} of max|default|; launches {launches}; "
          f"cpu fp32 part {cpu_s:.1f} s")
    del gpu_model, pipe, got, want, base
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 13. the chat slice ----------------------------------------------------------------
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[chat] random bf16 init of {n_params / 1e9:.3f} B parameters on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    pipe = G2VLMPipeline(model, cfg)
    lm, vocab, eos = model.language_model, cfg.llm.vocab_size, pipe.new_token_ids["eos_token_id"]
    frames = list(np.random.default_rng(0).integers(0, 256, (n_views, 294, 518, 3), dtype=np.uint8))
    # both towers run once per upload chunk of 8 views; a chunk's 23,328 patch rows go through the
    # ViT in two row chunks of 11,664
    vit_chunks = n_views * per_image // 11664
    n_k1_chat = cfg.dino.num_hidden_layers * UPLOAD_CHUNKS
    want_default = {K1: n_k1_chat, K2: cfg.vit.depth * vit_chunks + cfg.llm.num_hidden_layers}
    # the decode loop's fused kernels: the eager step and the captured one, each 28 decode_attention
    # and 2 x 28 + 1 add_rms_norm; the replays launch without the wrappers
    n_llm_chat = cfg.llm.num_hidden_layers
    want_decode = {"decode_attention": 2 * n_llm_chat, "add_rms_norm": 2 * (2 * n_llm_chat + 1)}

    # the cold call by hand: prefill, cache, one step's logits; then the decode loop eager and as a CUDA graph
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    prefill, hidden, kv, _, _ = pipe.chat_prefill(frames, QUESTION, device_preprocess=True)
    torch.cuda.synchronize()
    launches = _launches(fa)
    if launches != want_default or n_views * per_image % 11664:
        _fail(f"chat slice: prefill launches {launches}, expected {want_default}")
    real = torch.as_tensor(prefill.doc_id >= 0, device=dev)
    if len(prefill.doc_id) != len(pre.doc_id) or not torch.isfinite(hidden[real]).all():
        _fail(f"chat slice: prefill of {len(prefill.doc_id)} rows or non-finite hidden states")
    cache = decoding.build_cache(kv, prefill.seq_len, cfg.llm, len(prefill.doc_id) + 512, dtype=torch.bfloat16)  # 48,896 rows
    pos = int(prefill.next_rope_pos)
    logits, _ = decoding.decode_step(lm, cache, pipe._start_token(), pos, cfg.llm)
    if tuple(logits.shape) != (vocab,) or logits.dtype != torch.float32 or not torch.isfinite(logits).all():
        _fail(f"chat slice: first-step logits of shape {tuple(logits.shape)} or non-finite")
    tok = int(logits.argmax())

    def loop_ms(n_new, graph):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decoding.generate(lm, cache, tok, pos + 1, -1, cfg.llm, max_new_tokens=n_new, cuda_graph=graph)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    loop_ms(4, False)
    eager32, eager64 = loop_ms(32, False), loop_ms(64, False)
    graph32, graph64 = loop_ms(32, True), loop_ms(64, True)
    print(f"[chat] decode loop on a cache of {int(cache.length)} rows: eager {eager32:.1f} ms for 32 tokens, "
          f"{(eager64 - eager32) / 32:.3f} ms per further token; CUDA graph (one eager step, capture, replays) "
          f"{graph32:.1f} ms for 32 tokens, {(graph64 - graph32) / 32:.3f} ms per further token ({card})")
    if _launches(fa) != launches:
        _fail(f"chat slice: the decode loop launched an attention kernel: {fa.launch_counts}")
    del cache, kv, hidden, logits

    def chat_call(p_, **kw):
        fa.reset_launch_counts()
        df.reset_launch_counts()
        text, info = p_.chat(frames, QUESTION, max_new_tokens=32, device_preprocess=True, return_info=True, **kw)
        counts = {**_launches(fa), **_launches(df)}
        ids = info["token_ids"]
        if not ids or not all(0 <= t < vocab for t in ids) or not (len(ids) == 32 or ids[-1] == eos):
            _fail(f"chat slice: token ids {ids}")
        return info, counts

    infos = []
    for _ in range(3):
        info, chat_launches = chat_call(pipe)
        if chat_launches != {**want_default, **want_decode}:
            _fail(f"chat slice: launches {chat_launches}, expected {want_default} and {want_decode}")
        infos.append(info)
    if any(i["token_ids"] != infos[0]["token_ids"] for i in infos):
        _fail(f"chat slice: a second call gave other ids: {[i['token_ids'] for i in infos]}")

    def med(key):
        return statistics.median(i[key] for i in infos) * 1e3

    n_tok = infos[0]["num_tokens"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    chat_ms = {key: med(key) for key in ("t_prefill_s", "t_upload_s", "t_forward_s", "t_cache_s", "t_decode_s")}
    print(f"[chat] 32 views 294x518 bf16, prefill {infos[0]['prefill_len']} rows padded to {len(prefill.doc_id)}, "
          f"{n_tok} new tokens, medians of 3 warm calls: TTFT {chat_ms['t_prefill_s']:.1f} ms = upload + towers "
          f"{chat_ms['t_upload_s']:.1f} + prefill forward {chat_ms['t_forward_s']:.1f} + cache build "
          f"{chat_ms['t_cache_s']:.1f}; decode {chat_ms['t_decode_s']:.1f} ms, {chat_ms['t_decode_s'] / n_tok:.3f} "
          f"ms per token, {n_tok / chat_ms['t_decode_s'] * 1e3:.1f} tokens/s; peak allocated {peak:.2f} GiB; "
          f"launches per call {chat_launches}; ids {infos[0]['token_ids'][:8]}... ({card})")
    text, session = pipe.chat(frames, QUESTION, max_new_tokens=32, device_preprocess=True, return_session=True,
                              session_reserve=256)
    rows = int(session.cache.length)
    # (a session's larger cache changes the order of the attention sums: in bf16 on random weights
    # a near-tie of two logits may fall the other way, so the answers are not held equal here;
    # the CPU tests hold them equal in fp32)
    ids1 = [int(t) for t in text.split()]
    if not ids1 or not all(0 <= t < vocab for t in ids1):
        _fail(f"chat slice: the session call gave {ids1}")
    text2, session2 = pipe.chat_continue(session, FOLLOW_UP, max_new_tokens=8)
    ids2 = [int(t) for t in text2.split()]
    if not ids2 or not all(0 <= t < vocab for t in ids2) or int(session2.cache.length) <= rows:
        _fail(f"chat slice: chat_continue gave {ids2} on a cache of {int(session2.cache.length)} rows (was {rows})")
    print(f"[chat] chat_continue on the session: cache {rows} -> {int(session2.cache.length)} rows, ids {ids2}")
    del session, session2

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chat_call(pipe)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))

    # ---- 14. the same calls in the two other attention configurations -----------------------
    n_seg = cfg.vit.depth * vit_chunks + cfg.llm.num_hidden_layers
    paths_run = {"chat_call": chat_launches}
    n_k1_recon = cfg.dino.num_hidden_layers + cfg.pi3.depth * (2 + 2 * cfg.use_global_points)
    frames_arr = np.stack(frames)
    recon_times = {}
    for tag, kw, kname in (("default", {}, K2), ("attn_impl=int8", dict(attn_impl="int8"), K8),
                           ("attn_pipe", dict(attn_pipe=True), K4)):
        other = G2VLMPipeline(model, cfg, **kw)
        if kw:
            chat_call(other)
            info, counts = chat_call(other)  # the second, warm call is the one reported
            if counts != {K1: n_k1_chat, kname: n_seg, **want_decode}:
                _fail(f"chat slice {tag}: launches {counts}")
            paths_run["chat_call_" + ("int8" if kname == K8 else "pipe")] = counts
            # the int8 call's TTFT with the mma.sync K8 (PERF.md, H100 80GB HBM3 at 700 W)
            before = f"; with the parent's K8 {PARENT_INT8_TTFT_MS}" if kname == K8 else ""
            print(f"[chat] {tag}, one warm call: TTFT {info['t_prefill_s'] * 1e3:.1f} ms (default "
                  f"{chat_ms['t_prefill_s']:.1f}{before}) = upload + towers {info['t_upload_s'] * 1e3:.1f} + prefill forward "
                  f"{info['t_forward_s'] * 1e3:.1f} + cache build {info['t_cache_s'] * 1e3:.1f}; decode "
                  f"{info['t_decode_s'] * 1e3:.1f} ms; launches {counts}; ids {info['token_ids'][:8]}... ({card})")
        other.recon_from_frames(frames_arr)
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = other.recon_from_frames(frames_arr)
        torch.cuda.synchronize()
        recon_times[tag] = (time.perf_counter() - t0) * 1e3
        counts = _launches(fa)
        if counts != {K1: n_k1_recon, kname: cfg.llm.num_hidden_layers} or not torch.isfinite(out["points"]).all():
            _fail(f"recon call {tag}: launches {counts} or non-finite points")
        del out
    print("[recon] one warm 32-view recon call on the chat model: "
          + ", ".join(f"{tag} {ms_:.1f} ms" for tag, ms_ in recon_times.items())
          + (f"; phase 6 (the recon-stage model, median of 3) {recon_ms:.1f} ms" if recon_ms else "") + f" ({card})")
    del model, pipe, other
    torch.cuda.empty_cache()
    return paths_run


# chat-short's prompts (benchmark/traffic/mixes/chat_1to4x480x640): 1 and 4 views of 480x640, a
# question of the mix's longest 64 words and its longest answer of 64 tokens
DECODE_VIEWS, DECODE_HW, DECODE_WORDS, DECODE_NEW = (1, 4), (480, 640), 64, 64


def _per_layer_graph_ms(fn, layers: int, replays: int = 20) -> float:
    """ms of one call of fn(i), from a CUDA graph of fn(0), ..., fn(layers - 1) replayed: the device's
    time, not the host's for the Python around a launch (the decode step replays it in its graph
    too); calls on distinct layers' data leave the L2 as the step does."""
    import torch

    with torch.inference_mode():
        fn(0)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(layers):
                fn(i)
    graph.replay()
    return _time_ms(graph.replay, replays) / layers


def _decode_phase(env):
    """Phase 13(b): the MoT decode step on the fused kernels (ops/decode_fused.py) against the chain
    of plain tensor code, at chat-short's prompts on G2VLMConfig() with random bf16 weights. Returns
    the fused kernels' launches of one eager step ("decode_step") and of a pipe.chat call
    ("decode_chat")."""
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from g2vlm_tpu_torch.config import G2VLMConfig
    from g2vlm_tpu_torch.inference import decoding
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline, _round_up
    from g2vlm_tpu_torch.ops import decode_fused as df
    from g2vlm_tpu_torch.weights import build_model

    dev, card, bf16 = env.dev, env.card, torch.bfloat16
    t_phase = time.perf_counter()
    cfg = G2VLMConfig()
    llm = cfg.llm
    model = build_model(cfg, device=dev, dtype=bf16, seed=0)
    pipe = G2VLMPipeline(model, cfg)
    lm = model.language_model
    kvh, nh, d = llm.num_key_value_heads, llm.num_attention_heads, llm.head_dim
    rng = np.random.default_rng(13)
    question = " ".join(f"w{int(i)}" for i in rng.integers(0, 5000, DECODE_WORDS))
    inv = lm.rope_inv_freq(dev)
    # the main path first: pipe.chat at the 1-view prompt reaches the kernels on its own (the
    # eager step and the captured one; the replays launch without the wrappers)
    frames = list(rng.integers(0, 256, (DECODE_VIEWS[0], *DECODE_HW, 3), dtype=np.uint8))
    n_llm = llm.num_hidden_layers
    want_chat = {"decode_attention": 2 * n_llm, "add_rms_norm": 2 * (2 * n_llm + 1)}
    for _ in range(2):  # the second call is the one gated
        df.reset_launch_counts()
        _, info = pipe.chat(frames, question, max_new_tokens=DECODE_NEW, return_info=True)
        chat_launches = _launches(df)
    if chat_launches != want_chat or info["num_tokens"] != DECODE_NEW:
        _fail(f"decode: pipe.chat launched {chat_launches} (expected {want_chat}) for {info['num_tokens']} tokens")
    print(f"[decode] pipe.chat, {DECODE_VIEWS[0]} view of {DECODE_HW[0]}x{DECODE_HW[1]}, {DECODE_NEW} tokens: "
          f"decode {info['t_decode_s'] * 1e3:.1f} ms; fused launches {chat_launches} ({card})")
    real_fused = decoding._runs_fused
    results = {}
    step_launches = None
    for views in DECODE_VIEWS:
        frames = list(rng.integers(0, 256, (views, *DECODE_HW, 3), dtype=np.uint8))
        prefill, _, kv, _, _ = pipe.chat_prefill(frames, question)
        seq = int(prefill.seq_len)
        cap = max(_round_up(seq + DECODE_NEW + 8, 128), len(prefill.doc_id))  # as G2VLMPipeline.chat sizes it
        cache = decoding._batched(decoding.build_cache(kv, seq, llm, cap, dtype=bf16))
        tok = torch.tensor([17], dtype=torch.int64, device=dev)
        pos = torch.tensor([seq], dtype=torch.int64, device=dev)
        graphs, kernels_a_step = {}, {}
        for fused in (False, True):
            decoding._runs_fused = lambda *a, fused=fused: fused

            def step():
                return decoding._decode_step(lm, cache, tok, pos, llm, bf16, inv)

            with torch.inference_mode():
                cache.length.fill_(seq)
                df.reset_launch_counts()
                step()  # eager, then captured, as the decode loop does
                if fused:
                    step_launches = dict(df.launch_counts)
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    step()
            graphs[fused] = graph
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                graph.replay()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            kernels_a_step[fused] = (sum(not n.startswith(("Memcpy", "Memset")) for n in names), len(names))
        decoding._runs_fused = real_fused

        def replay(graph):
            def run():
                cache.length.fill_(seq)  # every replay on the prompt's cache: the same work
                graph.replay()
            return run

        fused_ms, chain_ms = _timed_in_turns(replay(graphs[True]), replay(graphs[False]), 50)
        results[views] = dict(seq=seq, cap=cap, fused_ms=fused_ms, chain_ms=chain_ms, kernels=kernels_a_step)
        print(f"[decode] {views} view(s) of {DECODE_HW[0]}x{DECODE_HW[1]}, {seq} cache rows in a capacity of {cap}: "
              f"one replayed step {fused_ms:.3f} ms on the fused kernels, {chain_ms:.3f} ms on the chain (in turns: "
              f"chain, fused, fused, chain; 50 replays each); kernels a replayed step (profiler; kernels, all device "
              f"ops) fused {kernels_a_step[True]}, chain {kernels_a_step[False]} ({card})")
        if kernels_a_step[True][0] == 0 or kernels_a_step[True][0] * 3 > kernels_a_step[False][0]:
            _fail(f"decode step: kernels a replayed step, fused {kernels_a_step[True]}, chain {kernels_a_step[False]}")

        # each kernel alone at this prompt's length, a different layer each launch (the 28 layers' cache
        # rows, 28 x ~7 MB at 7,100 rows, exceed the 50 MB L2, as in the step)
        gen = torch.Generator(device=dev).manual_seed(views)
        q = torch.randn(1, nh, d, generator=gen, device=dev).to(bf16)
        k = torch.randn(1, kvh, d, generator=gen, device=dev).to(bf16)
        v = torch.randn(1, kvh, d, generator=gen, device=dev).to(bf16)
        ang = torch.rand(1, d, generator=gen, device=dev) * seq
        cos, sin = torch.cos(ang), torch.sin(ang)
        at = lm.model.layers[0].self_attn
        qn, kn = at.q_norm.weight, at.k_norm.weight
        length = torch.tensor([seq], dtype=torch.int64, device=dev)
        scratch = df.decode_scratch(1, kvh, nh // kvh, cap, dev)
        def kernel(i=0, kc=None, vc=None):
            return df.decode_attention(q, k, v, cos, sin, cache.k[:, i] if kc is None else kc,
                                       cache.v[:, i] if vc is None else vc, length, qn, kn, llm.rms_norm_eps, scratch)

        def plain(kc=None, vc=None):
            return df.decode_attention_plain(q, k, v, cos, sin, cache.k[:, 0] if kc is None else kc,
                                             cache.v[:, 0] if vc is None else vc, length, qn, kn, llm.rms_norm_eps,
                                             df.decode_split(cap, kvh, 1, df._sm_count(dev))[0])

        qs = q.view(1, nh, 1, d)

        def library(i=0):
            return F.scaled_dot_product_attention(qs, cache.k[:, i, :, :seq], cache.v[:, i, :, :seq], enable_gqa=True)

        # the design not taken: a small kernel for the q/k norm, RoPE and the row store (stood in for by
        # decode_attention at length 0: its prologue, store and merge, no cache row read), then the
        # library's attention over the whole capacity with the rows at and beyond length + 1 masked
        # (the group's queries as rows of their KV head, so no GQA expansion)
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        visible = (torch.arange(cap, device=dev) <= seq).view(1, 1, 1, cap)
        qg = q.view(1, kvh, nh // kvh, d)

        def store_only(i=0):
            return df.decode_attention(q, k, v, cos, sin, cache.k[:, i], cache.v[:, i], zero, qn, kn,
                                       llm.rms_norm_eps, scratch)

        def alternative(i=0):
            store_only(i)
            return F.scaled_dot_product_attention(qg, cache.k[:, i], cache.v[:, i], attn_mask=visible)

        # kernel and plain version, each on its own copy of layer 0's cache: the output and the rows
        # stored at `seq` (the k row normed and roped, the v row as it came), every other row untouched
        kc0, vc0 = cache.k[:, 0].clone(), cache.v[:, 0].clone()
        kc_k, vc_k, kc_p, vc_p = kc0.clone(), vc0.clone(), kc0.clone(), vc0.clone()
        got = kernel(kc=kc_k, vc=vc_k)
        torch.cuda.synchronize()
        want = plain(kc=kc_p, vc=vc_p)
        err = (got.float() - want.float()).abs().max().item()
        out_steps = _bf16_steps(got, want)
        row_steps = _bf16_steps(kc_k[:, :, seq], kc_p[:, :, seq])
        others = torch.arange(cap, device=dev) != seq
        untouched = all(torch.equal(a[:, :, others], b[:, :, others]) for a, b in ((kc_k, kc0), (vc_k, vc0)))
        v_row_equal = torch.equal(vc_k[:, :, seq], vc_p[:, :, seq])
        ms = _per_layer_graph_ms(kernel, llm.num_hidden_layers)
        plain_ms = _time_ms(plain, 3)
        try:
            lib_ms, lib_why = _per_layer_graph_ms(library, llm.num_hidden_layers), None
        except RuntimeError as e_:  # a backend that cannot be captured: timed eagerly
            print(f"[decode] the library call in a CUDA graph: {str(e_).splitlines()[0][:120]}; timed eagerly")
            lib_ms, lib_why = _library_ms(library, 280)
        store_ms = _per_layer_graph_ms(store_only, llm.num_hidden_layers)
        try:
            alt_ms, alt_why = _per_layer_graph_ms(alternative, llm.num_hidden_layers), None
        except (RuntimeError, TypeError, ValueError) as e_:  # a mask or layout this PyTorch refuses
            alt_ms, alt_why = None, f"{type(e_).__name__}: {str(e_).splitlines()[0][:120]}"
        n_bytes = 2.0 * 2 * kvh * seq * d + 2.0 * d * (2 * nh + 4 * kvh)  # K, V rows; q, k, v, out, the stored rows
        bound_ms, bound_by = _bound(n_bytes, 4.0 * nh * seq * d)
        e = env.entry_for("decode_attention", "none: the port's own (the JAX package's decode step is XLA ops)",
                          "g2vlm_tpu_torch/csrc/decode_fused.cu")
        e.setdefault("shapes", []).append(
            {"rows": seq, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
             "store_only_ms": store_ms, "store_then_masked_library_ms": alt_ms})
        e.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                 max_abs_err=max(e["max_abs_err"], err))
        print(f"[decode] decode_attention at {seq} rows (12:2 heads of 128, B 1; device time in a CUDA graph of one "
              f"launch a layer, the 28 layers' rows beyond the L2): {ms * 1e3:.2f} us, bound "
              f"{bound_ms * 1e3:.2f} us by {bound_by} ({bound_ms / ms:.1%}); plain {plain_ms:.3f} ms; library "
              + (f"{lib_ms * 1e3:.2f} us (F.scaled_dot_product_attention, one query row, GQA, no norm / rope / "
                 f"self term / store){_ratio(ms, lib_ms)}" if lib_ms else f"not run: {lib_why}")
              + f"; the design not taken: norm / rope / store {store_ms * 1e3:.2f} us, then the masked library call "
              + (f"over the capacity of {cap}: {alt_ms * 1e3:.2f} us in all" if alt_ms else f"not run: {alt_why}")
              + f"; against the plain version: out max |diff| {err:.2e}, (bf16 steps, share) {out_steps}, stored k "
              f"row {row_steps}, v row equal {v_row_equal}, other rows untouched {untouched} ({card})")
        if (max(out_steps[0], row_steps[0]) > 1 or max(out_steps[1], row_steps[1]) > MAX_SHARE_ONE_STEP
                or not v_row_equal or not untouched):
            _fail(f"decode_attention at {seq} rows against its plain version: out {out_steps}, k row {row_steps} "
                  f"(at most 1 bf16 step on {MAX_SHARE_ONE_STEP:.0%}), v row equal {v_row_equal}, other rows "
                  f"untouched {untouched}")
        del cache, graphs, scratch
        gc.collect()
        torch.cuda.empty_cache()

    x = torch.randn(1, llm.hidden_size, generator=gen, device=dev).to(bf16)
    delta = torch.randn(1, llm.hidden_size, generator=gen, device=dev).to(bf16)
    w = lm.model.layers[0].post_attention_layernorm.weight
    got_s, got = df.add_rms_norm(x, delta, w, llm.rms_norm_eps)
    want_s, want = df.add_rms_norm_plain(x, delta, w, llm.rms_norm_eps)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    norm_steps, sum_equal = _bf16_steps(got, want), torch.equal(got_s, want_s)
    ms = _per_layer_graph_ms(lambda i: df.add_rms_norm(x, delta, w, llm.rms_norm_eps), 2 * llm.num_hidden_layers)
    plain_ms = _per_layer_graph_ms(lambda i: df.add_rms_norm_plain(x, delta, w, llm.rms_norm_eps),
                                   2 * llm.num_hidden_layers)
    summed = x + delta
    if hasattr(F, "rms_norm"):
        lib_ms, lib_why = _per_layer_graph_ms(lambda i: F.rms_norm(summed, (llm.hidden_size,), w, llm.rms_norm_eps),
                                              2 * llm.num_hidden_layers), None
    else:
        lib_ms, lib_why = None, f"torch {torch.__version__} has no F.rms_norm"
    bound_ms, bound_by = _bound(2.0 * llm.hidden_size * 5, 4.0 * llm.hidden_size)  # x, delta, w in; sum, y out
    e = env.entry_for("add_rms_norm", "none: the port's own (the JAX package's decode step is XLA ops)",
                      "g2vlm_tpu_torch/csrc/decode_fused.cu")
    e.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
    print(f"[decode] add_rms_norm of one row of {llm.hidden_size} (device time in a CUDA graph of 56 calls): "
          f"{ms * 1e3:.2f} us, bound {bound_ms * 1e3:.4f} us by {bound_by}; plain (x + d then rms_norm, its chain of "
          f"kernels) {plain_ms * 1e3:.2f} us; library "
          + (f"{lib_ms * 1e3:.2f} us (F.rms_norm of the sum){_ratio(ms, lib_ms)}" if lib_ms else f"not run: {lib_why}")
          + f"; against the plain version: max |diff| {err:.2e}, (bf16 steps, share) {norm_steps}, sum equal "
          f"{sum_equal} ({card})")
    if norm_steps[0] > 1 or norm_steps[1] > MAX_SHARE_ONE_STEP or not sum_equal:
        _fail(f"add_rms_norm against its plain version: {norm_steps}, sum equal {sum_equal}")
    rows = "; ".join(f"{v_} view(s), {r['seq']} rows: fused {r['fused_ms']:.3f} ms, chain {r['chain_ms']:.3f} ms "
                     f"({r['chain_ms'] / r['fused_ms']:.2f}x)" for v_, r in results.items())
    print(f"[decode] phase 13(b): a replayed step {rows}; eager step launches {step_launches}; "
          f"in {time.perf_counter() - t_phase:.1f} s ({card})")
    want_launches = {"decode_attention": llm.num_hidden_layers, "add_rms_norm": 2 * llm.num_hidden_layers + 1}
    if step_launches != want_launches:
        _fail(f"decode step: launches {step_launches}, expected {want_launches}")
    del model, pipe, lm
    gc.collect()
    torch.cuda.empty_cache()
    return {"decode_step": step_launches, "decode_chat": chat_launches}


REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def _images_phase(env):
    """Phase 26: the chat path's image resample on the card (ops/resample.py, csrc/image_resample.cu)
    at chat-short's shapes: each kernel bitwise its plain version and Pillow, timed beside its bytes
    bound, its plain version on the card and F.interpolate(antialias=True); a request's images on the
    kernels against the host PIL path they replaced; then G2VLMConfig() in bf16: 6 launches a chat
    request of 1-4 uniform frames and the served ids of the PIL path. Returns the launches of one
    4-frame chat request ("images_chat")."""
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F
    from PIL import Image

    from g2vlm_tpu_torch.config import G2VLMConfig
    from g2vlm_tpu_torch.data.images import RESNET_MEAN, RESNET_STD, load_views, resnet_normalize
    from g2vlm_tpu_torch.data.vit_preprocess import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD, preprocess_vit_image
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
    from g2vlm_tpu_torch.models import qwen_vit
    from g2vlm_tpu_torch.ops import resample as rs
    from g2vlm_tpu_torch.weights import build_model

    dev, card, bf16 = env.dev, env.card, torch.bfloat16
    t_phase = time.perf_counter()
    rng = np.random.default_rng(26)
    low = rng.integers(0, 256, (4, 60, 80, 3), dtype=np.uint8)  # chat-short's pool: one value an 8x8 block
    frames = np.repeat(np.repeat(low, 8, axis=1), 8, axis=2)
    x = torch.from_numpy(frames).to(dev)
    pil = {rs.LANCZOS: Image.Resampling.LANCZOS, rs.BICUBIC: Image.Resampling.BICUBIC}

    def pil_resize(arr, hw, filt):
        return np.stack([np.asarray(Image.fromarray(f).resize(hw[::-1], pil[filt])) for f in arr])

    def interp(t, hw, mode):  # the library's antialiased resize of the same frames, fp32 NCHW
        return lambda: F.interpolate(t, size=hw, mode=mode, antialias=True, align_corners=False)

    stage = rs.resize(x, (768, 768), rs.BICUBIC)
    h_lanczos = rs.resample_pass(x, 518, rs.LANCZOS, axis=2)
    h_768 = rs.resample_pass(x, 768, rs.BICUBIC, axis=2)
    h_756 = rs.resample_pass(stage, 756, rs.BICUBIC, axis=2)
    views_out = torch.empty((4, 3, 392, 518), dtype=bf16, device=dev)
    rows_out = torch.empty((4 * 2916, 1176), dtype=bf16, device=dev)
    tabs = {k: rs.table(*k, dev) for k in ((640, 518, rs.LANCZOS), (480, 392, rs.LANCZOS), (640, 768, rs.BICUBIC),
                                           (480, 768, rs.BICUBIC), (768, 756, rs.BICUBIC))}
    xf, stage_f = x.permute(0, 3, 1, 2).float(), stage.permute(0, 3, 1, 2).float()
    # (tag, kernel, plain version on the card, the host's Pillow or None, library call, bytes moved)
    cases = [
        ("resample_pass", "LANCZOS H 640->518 (4x480)", lambda: rs.resample_pass(x, 518, rs.LANCZOS, axis=2),
         lambda: rs.resample_pass_plain(x, tabs[640, 518, rs.LANCZOS], 2), None,
         interp(xf, (480, 518), "bicubic"), x.numel() + 4 * 480 * 518 * 3),
        ("resample_pass", "bicubic H 640->768 (4x480)", lambda: rs.resample_pass(x, 768, rs.BICUBIC, axis=2),
         lambda: rs.resample_pass_plain(x, tabs[640, 768, rs.BICUBIC], 2), None,
         interp(xf, (480, 768), "bicubic"), x.numel() + 4 * 480 * 768 * 3),
        ("resample_pass", "bicubic V 480->768 (4x768)", lambda: rs.resample_pass(h_768, 768, rs.BICUBIC, axis=1),
         lambda: rs.resample_pass_plain(h_768, tabs[480, 768, rs.BICUBIC], 1),
         pil_resize(frames, (768, 768), rs.BICUBIC), interp(xf, (768, 768), "bicubic"), h_768.numel() + stage.numel()),
        ("resample_pass", "bicubic H 768->756 (4x768)", lambda: rs.resample_pass(stage, 756, rs.BICUBIC, axis=2),
         lambda: rs.resample_pass_plain(stage, tabs[768, 756, rs.BICUBIC], 2), None,
         interp(stage_f, (768, 756), "bicubic"), stage.numel() + 4 * 768 * 756 * 3),
        ("resample_views", "LANCZOS V 480->392 + RESNET norm -> (4,3,392,518) bf16",
         lambda: rs.resample_views(h_lanczos, (392, 518), rs.LANCZOS, RESNET_MEAN, RESNET_STD, views_out),
         lambda: rs._normalize_plain(rs.resample_pass_plain(h_lanczos, tabs[480, 392, rs.LANCZOS], 1), RESNET_MEAN,
                                     RESNET_STD, bf16).permute(0, 3, 1, 2),
         torch.as_tensor(resnet_normalize(load_views(list(frames)))).to(bf16),
         interp(xf, (392, 518), "bicubic"), h_lanczos.numel() + views_out.numel() * 2),
        ("resample_patch_rows", "bicubic V 768->756 + CLIP norm -> (11664,1176) bf16 rows",
         lambda: rs.resample_patch_rows(h_756, (756, 756), rs.BICUBIC, OPENAI_CLIP_MEAN, OPENAI_CLIP_STD, rows_out),
         lambda: rs.tile_rows_plain(rs._normalize_plain(rs.resample_pass_plain(h_756, tabs[768, 756, rs.BICUBIC], 1),
                                                        OPENAI_CLIP_MEAN, OPENAI_CLIP_STD, bf16)),
         torch.as_tensor(qwen_vit.pack_views([dict(zip(("patches", "grid_thw"), preprocess_vit_image(f)))
                                              for f in frames])[0]).to(bf16),
         interp(stage_f, (756, 756), "bicubic"), h_756.numel() + rows_out.numel() * 2),
    ]
    totals = {}
    for kname, tag, kernel, plain, host, library, n_bytes in cases:
        got = kernel()
        torch.cuda.synchronize()
        equal_plain = torch.equal(got, plain())
        equal_host = host is None or torch.equal(got.cpu(), host if isinstance(host, torch.Tensor)
                                                 else torch.from_numpy(host))
        if not (equal_plain and equal_host):
            _fail(f"phase 26: {kname} ({tag}) bitwise its plain version {equal_plain}, the host path {equal_host}")
        ms = _time_ms(kernel, 200)
        plain_ms = _time_ms(plain, 20)
        lib_ms, lib_why = _library_ms(library, 200)
        bound_ms, bound_by = _bound(float(n_bytes), 0.0)
        e = env.entry_for(kname, "none: the port's own (the JAX package resizes on the host with PIL)",
                          "g2vlm_tpu_torch/csrc/image_resample.cu")
        e.setdefault("shapes", []).append({"case": tag, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                           "bound_ms": bound_ms})
        e.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
        totals[kname] = totals.get(kname, 0.0) + ms
        print(f"[images] {kname} {tag}: {ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us by {bound_by} "
              f"({bound_ms / ms:.1%}); plain on the card {plain_ms:.3f} ms; library "
              + (f"{lib_ms * 1e3:.2f} us (F.interpolate bicubic, antialias, fp32 NCHW){_ratio(ms, lib_ms)}"
                 if lib_ms else f"not run: {lib_why}")
              + "; bitwise its plain version" + (" and the host path" if host is not None else "") + f" ({card})")

    # a 4-frame request's images: the kernels (device and host ms) against the host PIL path
    cfg = G2VLMConfig()
    model = build_model(cfg, device=dev, dtype=bf16, seed=0)
    pipe = G2VLMPipeline(model, cfg)
    flat_host = np.ascontiguousarray(frames).reshape(-1)
    shapes, grid = [f.shape for f in frames], (1, 54, 54)

    def on_card():
        return pipe._chat_images(pipe._upload(flat_host), shapes, (392, 518), grid, 4 * 2916)

    def host_path():
        views = resnet_normalize(load_views(list(frames)))
        pats = qwen_vit.pack_views([dict(zip(("patches", "grid_thw"), preprocess_vit_image(f))) for f in frames],
                                   pad_to=4 * 2916)[0]
        return torch.as_tensor(views).to(dev, bf16), torch.as_tensor(pats).to(dev, bf16)

    got, want = on_card(), host_path()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        _fail("phase 26: a request's views / ViT rows on the kernels differ from the host PIL path's")
    host_ms = {"kernels": [], "pil": []}
    for i in range(6):
        for k in (("kernels", "pil") if i % 2 == 0 else ("pil", "kernels")):
            t0 = time.perf_counter()
            (on_card if k == "kernels" else host_path)()
            torch.cuda.synchronize()
            host_ms[k].append((time.perf_counter() - t0) * 1e3)
    dev_ms = _time_ms(on_card, 50)
    print(f"[images] a request of 4 frames of 480x640: upload + 6 kernels {statistics.median(host_ms['kernels']):.3f} "
          f"ms host-clock median (device {dev_ms:.3f} ms a request in a stream of 50), host PIL path + casts + "
          f"upload {statistics.median(host_ms['pil']):.3f} ms; kernels alone {sum(totals.values()):.3f} ms "
          f"({', '.join(f'{k} {v * 1e3:.1f} us' for k, v in totals.items())}); bitwise equal ({card})")

    # G2VLMConfig(): 6 launches a request, and the PIL path's served ids
    def pil_images(flat, shapes_, hw, grid_, rows):
        host = flat.cpu().numpy()
        imgs, off = [], 0
        for s_ in shapes_:
            imgs.append(host[off:off + int(np.prod(s_))].reshape(s_))
            off += int(np.prod(s_))
        views = resnet_normalize(load_views(imgs, new_width=hw[1]))
        pats = qwen_vit.pack_views([dict(zip(("patches", "grid_thw"), preprocess_vit_image(im))) for im in imgs],
                                   pad_to=rows)[0]
        return torch.as_tensor(views).to(dev, bf16), torch.as_tensor(pats).to(dev, bf16)

    pool = np.repeat(np.repeat(rng.integers(0, 256, (8, 60, 80, 3), dtype=np.uint8), 8, axis=1), 8, axis=2)
    served, launches = {}, {}
    for n in (1, 2, 3, 4):
        rs.reset_launch_counts()
        served[n] = pipe.chat(list(pool[n:2 * n]), QUESTION, max_new_tokens=24)
        launches[n] = {k: v for k, v in rs.launch_counts.items() if v}
    pipe._chat_images = pil_images
    same = {n: pipe.chat(list(pool[n:2 * n]), QUESTION, max_new_tokens=24) == served[n] for n in served}
    want_launches = {"resample_pass": 4, "resample_views": 1, "resample_patch_rows": 1}
    print(f"[images] G2VLMConfig() chat, 1-4 views: launches {launches}; served ids equal the PIL path's {same}; "
          f"phase 26 in {time.perf_counter() - t_phase:.1f} s ({card})")
    if any(v != want_launches for v in launches.values()) or not all(same.values()):
        _fail(f"phase 26: launches {launches} (expected {want_launches} a request), ids equal {same}")
    del model, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return {"images_chat": launches[4]}


def _write_views(folder: str, n: int, seed: int):
    """n random 294x518 RGB PNGs in `folder`; returns their paths."""
    import numpy as np
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    frames = np.random.default_rng(seed).integers(0, 256, (n, 294, 518, 3), dtype=np.uint8)
    paths = []
    for i, frame in enumerate(frames):
        paths.append(os.path.join(folder, f"view_{i:02d}.png"))
        Image.fromarray(frame).save(paths[-1])
    return paths


def _run_tools(*commands, timeout=600):
    """Run root scripts or modules of the port as subprocesses from the
    repository root, all at once; returns [(seconds, stdout)] in order. Fails
    on a non-zero exit; a process still running at the timeout is killed."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, *args], cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for args in commands]
    results = []
    try:
        for args, proc in zip(commands, procs):
            stdout, stderr = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            if proc.returncode != 0:
                _fail(f"{' '.join(args[:2])} exited {proc.returncode}: {stderr[-2000:]}")
            results.append((time.perf_counter() - t0, stdout))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def _read_ply_header(path: str):
    """(vertex count, header bytes, bytes per vertex) of a binary PLY."""
    with open(path, "rb") as f:
        raw = f.read(4096)
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    lines = raw[:end].decode().splitlines()
    n = int(next(line for line in lines if line.startswith("element vertex")).split()[-1])
    per = 4 * sum(line.startswith("property float") for line in lines) + sum(
        line.startswith("property uchar") for line in lines)
    return n, end, per


def _recon_entry_phase(env):
    """Phase 15. Returns the kernels' launches of one full-size `pipe.recon`
    call on 32 image paths (the recon entry path)."""
    import gc

    import numpy as np
    import torch

    from g2vlm_tpu_torch.config import G2VLMConfig, cut_depth_config
    from g2vlm_tpu_torch.data.images import load_views, resnet_normalize
    from g2vlm_tpu_torch.data.synthetic import make_tiny_scene_jsonl
    from g2vlm_tpu_torch.inference.pipeline import RECON_PROMPT, G2VLMPipeline
    from g2vlm_tpu_torch.ops import flash_attention as fa
    from g2vlm_tpu_torch.weights import build_model, load_checkpoint, save_safetensors

    dev, card = env.dev, env.card
    K1, K2 = "flash_batched_attention", "flash_segment_attention"
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="g2vlm_smoke_")

    def recon_launches(cfg):
        return {K1: cfg.dino.num_hidden_layers + cfg.pi3.depth * (2 + 2 * cfg.use_global_points),
                K2: cfg.llm.num_hidden_layers}

    def counted_recon(pipe, paths):
        fa.reset_launch_counts()
        out = pipe.recon(paths)
        torch.cuda.synchronize()
        return out, _launches(fa)

    # ---- 15a. checkpoint round trip at full width, cut depth ------------------------------
    full = G2VLMConfig()
    cut = dataclasses.replace(cut_depth_config(full, 2), pi3=full.pi3)  # the config files hold no Pi3 field
    token_ids = dict(bos_token_id=1, eos_token_id=2, start_of_image=3, end_of_image=4)
    model = build_model(cut, device=dev, dtype=torch.bfloat16, seed=0)
    sd = model.state_dict()
    ckpt = os.path.join(work, "ckpt")
    os.makedirs(ckpt)
    t0 = time.perf_counter()
    save_safetensors(os.path.join(ckpt, "model.safetensors"), sd)
    for name, sub in (("text_config.json", cut.llm), ("vit_config.json", cut.vit), ("dino_config.json", cut.dino)):
        with open(os.path.join(ckpt, name), "w") as f:
            json.dump(dataclasses.asdict(sub), f)
    t_write = time.perf_counter() - t0
    n_bytes = os.path.getsize(os.path.join(ckpt, "model.safetensors"))
    [(t_audit, audit)] = _run_tools(["-m", "g2vlm_tpu_torch.weights", "--audit", ckpt])
    if "AUDIT: PASS" not in audit:
        _fail(f"--audit of the written checkpoint did not pass: {audit[-2000:]}")
    t0 = time.perf_counter()
    loaded, loaded_cfg = load_checkpoint(ckpt, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    got = loaded.state_dict()
    if set(got) != set(sd) or not all(torch.equal(got[k], v) for k, v in sd.items()):
        _fail("load_checkpoint: the loaded tensors are not bitwise the written ones")
    if json.dumps(dataclasses.asdict(loaded_cfg)) != json.dumps(dataclasses.asdict(cut)):
        _fail("load_checkpoint: the config read back differs from the one written")
    print(f"[entry] checkpoint of {len(sd)} tensors, {n_bytes / 2**30:.3f} GiB bf16: written in {t_write:.2f} s, "
          f"--audit (a subprocess, PASS) {t_audit:.2f} s, load_checkpoint onto the card {t_load:.2f} s; "
          f"every tensor bitwise equal ({card})")
    paths8 = _write_views(os.path.join(work, "views8"), 8, seed=4)
    outs = []
    for tag, m, c in (("original", model, cut), ("loaded", loaded, loaded_cfg)):
        out, counts = counted_recon(G2VLMPipeline(m, c, new_token_ids=token_ids), paths8)
        if counts != recon_launches(c):
            _fail(f"recon entry ({tag} model): launches {counts}, expected {recon_launches(c)}")
        if not all(np.isfinite(v).all() for v in out.values()):
            _fail(f"recon entry ({tag} model): non-finite outputs")
        outs.append(out)
    if outs[0].keys() != outs[1].keys() or not all(np.array_equal(outs[0][k], outs[1][k]) for k in outs[0]):
        _fail("recon entry: the loaded model's outputs are not bitwise the original's")
    print(f"[entry] pipe.recon on 8 PNG paths: loaded and original models bitwise equal, finite, launches "
          f"{recon_launches(cut)} per call")
    del model, loaded, sd, got, outs
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 15b. infer_recon_torch.py at full size, then pipe.recon timed ----------------------
    n_views = 32
    folder = os.path.join(work, "views32")
    paths = _write_views(folder, n_views, seed=5)
    ply = os.path.join(work, "recon.ply")
    [(t_cli, stdout)] = _run_tools(["infer_recon_torch.py", "--image_folder", folder, "--save_path", ply])
    stats = ast.literal_eval(stdout.strip().splitlines()[-1].split(": ", 1)[1])
    n_vertex, header_bytes, per = _read_ply_header(ply)
    if not n_vertex == stats["written"] == n_views * 294 * 518 - stats["invalid"]:
        _fail(f"infer_recon_torch.py: header {n_vertex} vertices, reported {stats}")
    if os.path.getsize(ply) != header_bytes + n_vertex * per:
        _fail(f"infer_recon_torch.py: {ply} holds {os.path.getsize(ply)} bytes, the header says "
              f"{header_bytes + n_vertex * per}")
    print(f"[entry] infer_recon_torch.py, {n_views} PNG views of 294x518, random bf16 weights: exit 0 in {t_cli:.1f} s "
          f"wall (interpreter, model init, kernels loaded from the build, PIL, recon, PLY); {n_vertex} vertices "
          f"({stats['invalid']} invalid), {os.path.getsize(ply) / 2**20:.1f} MiB, header and size consistent ({card})")
    os.unlink(ply)

    cfg = G2VLMConfig(visual_und=False)
    model = build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)  # phase 6's model
    pipe = G2VLMPipeline(model, cfg)
    pipe.recon(paths)  # warm
    out, launches = counted_recon(pipe, paths)
    if launches != recon_launches(cfg) or out["points"].shape != (n_views, 294, 518, 3):
        _fail(f"recon entry, full size: launches {launches}, points {out['points'].shape}")
    if not all(np.isfinite(v).all() for v in out.values()):
        _fail("recon entry, full size: non-finite outputs")
    whole = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipe.recon(paths)
        whole.append((time.perf_counter() - t0) * 1e3)
    # the steps of `recon`, one by one, each closed by a synchronisation
    names = ("load_views (PIL decode + LANCZOS, host)", "resnet_normalize (host)", "fp32 upload",
             "forward (device)", "outputs to numpy")
    spans = {name: [] for name in names}
    for _ in range(3):
        t = [time.perf_counter()]
        views = load_views(paths)
        t.append(time.perf_counter())
        normed_host = resnet_normalize(views)
        t.append(time.perf_counter())
        normed = torch.as_tensor(normed_host, dtype=torch.float32).to(dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        with torch.inference_mode():
            res = pipe._recon(normed, RECON_PROMPT)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        {k: v.float().cpu().numpy() for k, v in res.items()}
        t.append(time.perf_counter())
        for name, a, b in zip(names, t, t[1:]):
            spans[name].append((b - a) * 1e3)
    med = statistics.median
    split = " + ".join(f"{name} {med(v):.1f}" for name, v in spans.items())
    print(f"[entry] pipe.recon on {n_views} PNG paths of 294x518, bf16: {med(whole):.1f} ms per call (median of "
          f"{[round(t, 1) for t in whole]}); spans (medians of 3, ms): {split} = "
          f"{sum(med(v) for v in spans.values()):.1f}; launches {launches} ({card})")
    del model, pipe, out, views, normed, res
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 15c. the evaluation tools at full size ---------------------------------------------
    os.makedirs(os.path.join(work, "scene"))
    scene = make_tiny_scene_jsonl(os.path.join(work, "scene"))
    tools = ("eval_points_torch.py", "eval_camera_torch.py")
    for tool, (t_tool, stdout) in zip(tools, _run_tools(*([tool, "--jsonl", scene] for tool in tools))):
        scores = {line.split(":")[0]: float(line.split(":")[1]) for line in stdout.splitlines()
                  if line.startswith(("AUC@", "local-abs-rel", "world-rmse"))}
        if len(scores) != (5 if "camera" in tool else 2) or not all(np.isfinite(v) for v in scores.values()):
            _fail(f"{tool}: scores {scores} from {stdout[-1000:]}")
        print(f"[entry] {tool} --jsonl (synthetic scene, 4 views, full size, random bf16 weights; both tools at "
              f"once): exit 0 after {t_tool:.1f} s, scores {scores} (random weights: not a quality number) ({card})")
    shutil.rmtree(work)
    print(f"[entry] phase 15 in {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches



def _joint_pack(folder, n_views, view_hw, n_vit, vit_hw, max_tokens, max_vit, vocab, seed):
    """One pack as a recon_then_und sample lays it out, built by the port's
    SequencePacker from PNG files it writes into `folder` first: a prompt,
    `n_views` DINOv2 views of `view_hw` (positive depths, world points from
    them), `n_vit` ViT images resized to `vit_hw` and smart-resized, a
    question and a 32-token answer with the loss; the sorted [und | geo]
    layout. Returns (the packer's batch dict, host ms of the pack from the
    files: PIL decode, the native ViT preprocess, the packing, cojitter and
    normalisation)."""
    import random

    import numpy as np
    from PIL import Image

    from g2vlm_tpu_torch.data.packing import PackerConfig, SequencePacker
    from g2vlm_tpu_torch.data.recon_dataset import depth_to_world_points
    from g2vlm_tpu_torch.data.vit_preprocess import preprocess_vit_image_fast

    rng = np.random.default_rng(seed)
    h, w = view_hw
    os.makedirs(folder, exist_ok=True)
    dino_paths, vit_paths = [], []
    for i in range(n_views):
        dino_paths.append(os.path.join(folder, f"view_{i}.png"))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(dino_paths[-1])
    for i in range(n_vit):
        vit_paths.append(os.path.join(folder, f"image_{i}.png"))
        Image.fromarray(rng.integers(0, 256, (*vit_hw, 3), dtype=np.uint8)).save(vit_paths[-1])
    ids = dict(bos_token_id=vocab - 4, eos_token_id=vocab - 3, start_of_image=vocab - 2, end_of_image=vocab - 1)
    intr = np.asarray([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]], np.float32)
    t0 = time.perf_counter()
    dino_views = []
    for i, path in enumerate(dino_paths):
        depth = (1.5 + rng.random((h, w))).astype(np.float32)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = (0.1 * i, 0.02 * i, 0.05 * i)
        pts, valid = depth_to_world_points(depth, intr, c2w)
        dino_views.append(dict(image=np.asarray(Image.open(path).convert("RGB")), depths=depth, extrinsics=c2w,
                               intrinsics=intr, world_points=pts, point_masks=valid, view_infos=f"view/{i}",
                               image_paths=path))
    vit_views = []
    for path in vit_paths:
        patches, grid = preprocess_vit_image_fast(path, target_hw=vit_hw)
        vit_views.append({"patches": patches, "grid_thw": grid})
    text = [list(rng.integers(100, min(5000, vocab - 4), n)) for n in (8, 16, 32)]
    plan = ([{"type": "text"}] + [{"type": "dino_image"}] * n_views + [{"type": "vit_image"}] * n_vit
            + [{"type": "text"}, {"type": "text", "loss": 1}])
    packer = SequencePacker(PackerConfig(max_num_tokens=max_tokens, max_vit_patches=max_vit), ids)
    packer.add_sample(dict(plan=plan, text_ids_list=text, dino_views=dino_views, vit_views=vit_views),
                      random.Random(seed))
    batch = packer.to_batch(random.Random(seed), sorted_layout=True, geo_start_bucket=256)
    return batch, (time.perf_counter() - t0) * 1e3


def _joint_step_phase(env):
    """Phase 17 (16 runs with phases 7-8). Returns the kernels' launches of
    the last full-size joint training step, and its config, model, optimizer
    and train state, which phase 22(b) steps on."""
    import gc

    import torch

    import train_torch
    from g2vlm_tpu_torch.config import G2VLMConfig, cut_depth_config
    from g2vlm_tpu_torch.ops import flash_attention as fa
    from g2vlm_tpu_torch.train import trainer
    from g2vlm_tpu_torch.weights import build_model

    dev, card = env.dev, env.card
    gc.collect()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="g2vlm_joint_")
    t_phase = time.perf_counter()

    # ---- 17a. joint parity at cut depth: card (fp32 masters, bf16 compute, kernels) vs CPU (fp32) ----
    cut = cut_depth_config(G2VLMConfig(), 2)
    b, _ = _joint_pack(os.path.join(work, "cut"), 2, TRAIN_HW, 2, (448, 448), 2304, 2048, cut.llm.vocab_size, 5)
    cut_batch = train_torch.batch_from_pack(b).map(lambda x: x[0])
    cut_geo_start = b["geo_start"]
    groups = {"llm": "language_model.", "vit": "vit_model."}

    def grad_norms(m):
        return {g: sum(p.grad.float().square().sum().item() for n_, p in m.named_parameters()
                       if n_.startswith(prefix) and p.grad is not None) ** 0.5 for g, prefix in groups.items()}

    cpu_model = build_model(cut, device="cpu", dtype=torch.float32, seed=0).train()
    trainer.apply_freeze(cpu_model, freeze_recon=True)
    t0 = time.perf_counter()
    want_loss, _ = trainer.train_forward(cpu_model, cut_batch, cut, compute_dtype=torch.float32,
                                         geo_start=cut_geo_start)
    want_loss.backward()
    cpu_s = time.perf_counter() - t0
    want_norms = grad_norms(cpu_model)
    gpu_model = build_model(cut, device=dev, dtype=torch.float32, seed=None).train()
    gpu_model.load_state_dict(cpu_model.state_dict())
    trainer.apply_freeze(gpu_model, freeze_recon=True)
    want_launches = _step_launches(cut, vit=True, freeze_recon=True)
    fa.reset_launch_counts()
    got_loss, _ = trainer.train_forward(gpu_model, cut_batch.map(lambda x: x.to(dev)), cut,
                                        compute_dtype=torch.bfloat16, geo_start=cut_geo_start)
    got_loss.backward()
    torch.cuda.synchronize()
    launches = _launches(fa)
    if launches != want_launches:
        _fail(f"joint parity: launches {launches}, expected {want_launches}")
    rel = abs(got_loss.item() - want_loss.item()) / abs(want_loss.item())
    print(f"[joint-parity] 2 views of {TRAIN_HW[0]}x{TRAIN_HW[1]} + 2 ViT images of 448x448, --freeze_recon: loss "
          f"card {got_loss.item():.5f} cpu {want_loss.item():.5f} rel {rel:.3e} (budget 3e-2); cpu fp32 "
          f"forward+backward {cpu_s:.1f} s; launches {launches}")
    if not rel <= 3e-2:
        _fail(f"joint parity: loss off by {rel} (budget 3e-2)")
    got_norms = grad_norms(gpu_model)
    for g, w in want_norms.items():
        r = abs(got_norms[g] - w) / w
        print(f"[joint-parity] grad norm {g}: card {got_norms[g]:.4e} cpu {w:.4e} rel {r:.3e} (budget 1e-1)")
        if not (w > 0 and r <= 1e-1):
            _fail(f"joint parity: grad norm of {g} off by {r} (budget 1e-1)")
    frozen_with_grad = [n_ for n_, p in gpu_model.named_parameters() if not p.requires_grad and p.grad is not None]
    if frozen_with_grad:
        _fail(f"joint parity: frozen leaves got gradients: {frozen_with_grad[:3]}")
    del cpu_model, gpu_model, got_loss, want_loss, cut_batch
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 17b. the joint training step at full width and depth -------------------------------------
    cfg = G2VLMConfig()
    b, host_ms = _joint_pack(os.path.join(work, "full"), TRAIN_VIEWS // 2, TRAIN_HW, VIT_TRAIN_IMAGES, (768, 768),
                             TRAIN_TOKENS, VIT_TRAIN_IMAGES * VIT_ROWS_PER_IMAGE, cfg.llm.vocab_size, 6)
    geo_start = b["geo_start"]
    real_tokens = int((b["doc_id"] >= 0).sum())
    batch = train_torch.batch_from_pack(b, dev)
    vit_rows = int((b["vit_seg"] >= 0).sum())
    print(f"[joint] one pack by SequencePacker from {TRAIN_VIEWS // 2} + {VIT_TRAIN_IMAGES} PNGs: {real_tokens} "
          f"real tokens in {TRAIN_TOKENS} rows, {vit_rows} ViT patch rows in {len(b['vit_seg'])} slots, geo_start "
          f"{geo_start}; host {host_ms:.1f} ms (PIL decode, native ViT preprocess, packing, cojitter, "
          f"normalisation) ({card})")
    if vit_rows != VIT_TRAIN_IMAGES * VIT_ROWS_PER_IMAGE:
        _fail(f"joint pack: {vit_rows} ViT patch rows, expected {VIT_TRAIN_IMAGES * VIT_ROWS_PER_IMAGE}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.float32, seed=0).train()
    optimizer = trainer.make_optimizer(
        model, schedule=trainer.warmup_cosine_schedule(0.0, 1e-4, 0, 1000), weight_decay=0.05,
        freeze_recon=True, mu_dtype=torch.bfloat16, factored_v=True)
    state = trainer.init_train_state(model, optimizer, ema=True)
    step_fn = trainer.make_train_step(cfg, compute_dtype=torch.bfloat16, ema_decay=0.9999, geo_start=geo_start)
    torch.cuda.synchronize()
    n_all = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in optimizer.params)
    state_gb = (4 * n_all * 2 + 4 * n_train + 2 * n_train) / 1e9
    print(f"[joint] fp32 init of {n_all / 1e9:.3f} B parameters ({n_train / 1e9:.3f} B trainable: the und expert, "
          f"the ViT, embeddings and lm_head), optimizer and EMA on the card in {time.perf_counter() - t0:.1f} s; "
          f"state reckoned {state_gb:.1f} GB (masters + EMA of all, gradients fp32 + bf16 first moment of the "
          f"trainable) ({card})")
    joint_launches = _full_size_steps(
        env, "joint", state, step_fn, batch, real_tokens, _step_launches(cfg, vit=True, freeze_recon=True),
        "G2VLMConfig(), --split_layout --freeze_recon --factored_v --mu_dtype bfloat16, remat")
    del step_fn, batch
    gc.collect()
    shutil.rmtree(work)
    print(f"[joint] phase 17 in {time.perf_counter() - t_phase:.1f} s ({card})")
    return joint_launches, SimpleNamespace(cfg=cfg, model=model, optimizer=optimizer, state=state)


def _data_resume_phase(env):
    """Phase 18: train_torch.py on a data config at cut depth, run A against run B resumed."""
    import gc

    import torch
    import yaml

    from g2vlm_tpu_torch.config import G2VLMConfig, cut_depth_config
    from g2vlm_tpu_torch.data.synthetic import make_tiny_joint_data
    from g2vlm_tpu_torch.train import trainer
    from g2vlm_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager, state_tensors
    from g2vlm_tpu_torch.weights import build_model, load_safetensors

    dev, card = env.dev, env.card
    work = tempfile.mkdtemp(prefix="g2vlm_data_")
    t_phase = time.perf_counter()
    cut = cut_depth_config(G2VLMConfig(), 2)
    data = os.path.join(work, "data")
    os.makedirs(data)
    data_cfg = make_tiny_joint_data(data, target_size=TRAIN_HW[1], vit_hw=(448, 448))
    # packs close once they hold 2,000 tokens; a sample may take half of the 16,384 rows (4 views of up to
    # 44 x 37 patches do); at most three ViT images of 1,024 patch rows join a pack before it closes
    common = ["--data_config", os.path.join(data, "joint.yaml"), "--cut_depth", "2", "--max_vit_patches", "4096",
              "--max_num_tokens", "16384", "--expected_num_tokens", "2000", "--image_num_range", "2", "4",
              "--split_layout", "--freeze_recon", "--factored_v", "--mu_dtype", "bfloat16", "--ckpt_every", "2",
              "--log_every", "1"]
    with open(common[1], "w") as f:
        yaml.safe_dump(data_cfg, f)
    got_a, worst, t_runs = _resume_runs(common, work, "resume")
    print(f"[data] train_torch.py --data_config (2 synthetic scenes of 84x140 views at {TRAIN_HW[1]} wide, 3 image "
          f"conversations at 448x448) --cut_depth 2 --split_layout --freeze_recon, subprocesses with PYTHONHASHSEED=0 (PyYAML "
          f"{yaml.__version__}): A 4 steps, B 2 steps "
          f"then --resume for 2, all in {t_runs:.1f} s; steps 2-3 of B against A: worst metric {worst:.2e} "
          f"relative (budget 1e-3); data_status equal; A's losses {[got_a[s]['loss'] for s in range(4)]} ({card})")

    # B's checkpoint 2 (rewritten by the resumed run after its step 2, as train.py labels a mid-run save by
    # the step just run), restored on the card: bitwise the file, and its write time
    model = build_model(cut, device=dev, dtype=torch.float32, seed=1).train()
    optimizer = trainer.make_optimizer(model, freeze_recon=True, mu_dtype=torch.bfloat16, factored_v=True)
    state = trainer.init_train_state(model, optimizer, ema=True)
    mgr = CheckpointManager(os.path.join(work, "ckB"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, status = mgr.restore(state, step=2)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    saved = load_safetensors(os.path.join(work, "ckB", "2", STATE_FILE))
    restored = state_tensors(state)
    if set(saved) != set(restored) or not all(torch.equal(restored[k].cpu(), v) for k, v in saved.items()):
        _fail("restore: the restored tensors are not bitwise the saved ones")
    if status != json.load(open(os.path.join(work, "ckB", "data_status_2.json"))) or state.step != int(saved["step"]):
        _fail(f"restore: data_status or step ({state.step}) differ from the saved ones")
    out = CheckpointManager(os.path.join(work, "ck_again"))
    t0 = time.perf_counter()
    out.save(state.step, state, data_status=status)
    t_write = time.perf_counter() - t0
    n_bytes = os.path.getsize(os.path.join(work, "ck_again", str(state.step), STATE_FILE))
    print(f"[data] checkpoint of {len(saved)} tensors, {n_bytes / 2**30:.3f} GiB (fp32 parameters and EMA of "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M, factored Adam state): written from the card "
          f"in {t_write:.2f} s, restored onto it in {t_restore:.2f} s, every tensor and data_status bitwise "
          f"equal ({card})")
    del model, optimizer, state, saved, restored
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work)
    print(f"[data] phase 18 in {time.perf_counter() - t_phase:.1f} s ({card})")


def _resume_runs(common, work, tag):
    """train_torch.py with the flags `common`: run A takes 4 steps with checkpoints in work/ckA, run B
    2 steps in work/ckB (both at once), then B --resume for 2 more; subprocesses with
    PYTHONHASHSEED=0, each allowed 300 s. Fails unless B's steps 2-3 match A's within 1e-3 (relative,
    plus the 1e-4 of the log's 4 decimals) and the final data_status files are equal. Returns (A's
    metrics by step, the worst relative difference, seconds of the runs)."""
    runs = {"A": ["--steps", "4", "--checkpoint_dir", os.path.join(work, "ckA")],
            "B": ["--steps", "2", "--checkpoint_dir", os.path.join(work, "ckB")],
            "B_resumed": ["--steps", "4", "--checkpoint_dir", os.path.join(work, "ckB"), "--resume"]}

    def start(argv):
        return subprocess.Popen([sys.executable, "train_torch.py", *common, *argv], cwd=REPO_ROOT, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                env=dict(os.environ, PYTHONHASHSEED="0"))

    def finish(procs):
        """Waits for each run of `procs` (tag -> process); fails on a non-zero exit or a run still going
        after 300 s, and leaves none running."""
        out = {}
        try:
            for run, proc in procs.items():
                try:
                    _, err = proc.communicate(timeout=300)
                except subprocess.TimeoutExpired:
                    _fail(f"{tag}: train_torch.py run {run} still ran after 300 s")
                if proc.returncode != 0:
                    _fail(f"{tag}: train_torch.py run {run} exited {proc.returncode}: {err[-2000:]}")
                out[run] = err
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return out

    t0 = time.perf_counter()
    logs = finish({run: start(runs[run]) for run in ("A", "B")})  # A and B's first part at once
    logs.update(finish({"B_resumed": start(runs["B_resumed"])}))
    t_runs = time.perf_counter() - t0

    def step_metrics(log):
        out = {}
        for line in log.splitlines():
            if " step " in line and "loss=" in line:
                words = line[line.index(" step ") + 6:].split()
                out[int(words[0])] = {k: float(v) for k, v in (w.split("=") for w in words[1:] if "=" in w)}
        return out

    got_a, got_b = step_metrics(logs["A"]), step_metrics(logs["B_resumed"])
    if "resumed at step 2" not in logs["B_resumed"] or sorted(got_a) != [0, 1, 2, 3] or sorted(got_b) != [2, 3]:
        _fail(f"{tag}: steps logged A {sorted(got_a)}, B resumed {sorted(got_b)}: {logs['B_resumed'][-1500:]}")
    worst = 0.0
    for step in (2, 3):
        for k, v in got_a[step].items():
            err = abs(got_b[step][k] - v)
            worst = max(worst, err / (abs(v) + 1e-30))
            if err > 1e-3 * abs(v) + 1e-4:  # 1e-4: the 4 decimals the log prints
                _fail(f"{tag}: step {step} {k} {got_b[step][k]} against {v} uninterrupted (1e-3 relative)")
    status_a = json.load(open(os.path.join(work, "ckA", "data_status_4.json")))
    status_b = json.load(open(os.path.join(work, "ckB", "data_status_4.json")))
    if status_a != status_b:
        _fail(f"{tag}: the data_status of the resumed run differs from the uninterrupted one's")
    return got_a, worst, t_runs


def _step_parity(env, tag, cpu_model, cfg, batch, geo_start, groups, want_launches, freeze, details=()):
    """One forward + backward of `cpu_model` on the CPU (fp32, the plain versions) and of a copy of it
    on the card (fp32 masters, bf16 compute, the kernels), each with `freeze` (apply_freeze's flags):
    the loss and each of `details` within 3e-2 of the CPU's, each group's gradient norm (a prefix or a
    tuple of prefixes) within 1e-1, the card's launches exactly `want_launches`. Returns the card's
    model."""
    import torch

    from g2vlm_tpu_torch.ops import flash_attention as fa
    from g2vlm_tpu_torch.train import trainer
    from g2vlm_tpu_torch.weights import build_model

    def grad_norms(m):
        return {g: sum(p.grad.float().square().sum().item() for n_, p in m.named_parameters()
                       if n_.startswith(prefix) and p.grad is not None) ** 0.5 for g, prefix in groups.items()}

    one = batch.map(lambda x: x[0])
    cpu_model.train()
    trainer.apply_freeze(cpu_model, **freeze)
    t0 = time.perf_counter()
    want_loss, want_det = trainer.train_forward(cpu_model, one, cfg, compute_dtype=torch.float32, geo_start=geo_start)
    want_loss.backward()
    cpu_s = time.perf_counter() - t0
    want_norms = grad_norms(cpu_model)
    gpu_model = build_model(cfg, device=env.dev, dtype=torch.float32, seed=None).train()
    gpu_model.load_state_dict(cpu_model.state_dict())
    trainer.apply_freeze(gpu_model, **freeze)
    fa.reset_launch_counts()
    got_loss, got_det = trainer.train_forward(gpu_model, one.map(lambda x: x.to(env.dev)), cfg,
                                              compute_dtype=torch.bfloat16, geo_start=geo_start)
    got_loss.backward()
    torch.cuda.synchronize()
    launches = _launches(fa)
    if launches != want_launches:
        _fail(f"{tag}: launches {launches}, expected {want_launches}")
    for key, got, want in [("loss", got_loss, want_loss)] + [(k, got_det[k], want_det[k]) for k in details]:
        rel = abs(got.item() - want.item()) / abs(want.item())
        print(f"[{tag}] {key}: card {got.item():.5f} cpu {want.item():.5f} rel {rel:.3e} (budget 3e-2)")
        if not rel <= 3e-2:
            _fail(f"{tag}: {key} off by {rel} (budget 3e-2)")
    got_norms = grad_norms(gpu_model)
    for g, w in want_norms.items():
        r = abs(got_norms[g] - w) / w
        print(f"[{tag}] grad norm {g}: card {got_norms[g]:.4e} cpu {w:.4e} rel {r:.3e} (budget 1e-1)")
        if not (w > 0 and r <= 1e-1):
            _fail(f"{tag}: grad norm of {g} off by {r} (budget 1e-1)")
    print(f"[{tag}] cpu fp32 forward+backward {cpu_s:.1f} s; card launches {launches} ({env.card})")
    return gpu_model


def _tame_point_heads(model):
    """Scale the point heads' projections by 0.1 in place, as the CPU parity tests do with random
    weights (tests/test_torch_recon.py `_random_params`): a seeded init puts z = log depth in about
    [-7, 8], where exp(z) turns bf16's few-1e-2 absolute error in z into as much relative error of the
    largest point (a cut 'dense' model unscaled: 3.4e-2 with z in [-6.3, 8.3]); the scaled heads keep
    z, and so exp(z), in a range a trained model gives. Used by the parity checks of phases 20 and 21."""
    import torch

    with torch.no_grad():
        for name in ("point_head", "global_point_head"):
            getattr(model, name).proj.weight.mul_(0.1)
    return model


PI3_GROUPS = {"dino": "dino_model.", "llm": "language_model.", "dino2llm": "dino2llm.",
              "point": ("point_decoder.", "point_head."), "camera": ("camera_decoder.", "camera_head."),
              "global": ("global_points_decoder.", "global_point_head.")}


def _conf_stage_phase(env):
    """Phase 19, the conf-head training stage (train_torch.py --train_conf). Returns the kernels'
    launches of the last full-size step."""
    import gc

    import torch

    import train_torch
    from g2vlm_tpu_torch.config import G2VLMConfig, cut_depth_config
    from g2vlm_tpu_torch.models import segformer
    from g2vlm_tpu_torch.train import trainer
    from g2vlm_tpu_torch.weights import build_model

    dev, card = env.dev, env.card
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(G2VLMConfig(visual_und=False), train_conf_pi3=True)

    # ---- 19a. cut-depth parity: card (fp32 masters, bf16 compute, kernels) vs CPU (fp32, plain) -----
    cut = cut_depth_config(cfg, 2)
    batch, geo_start = train_torch.full_size_batch(cut, 2, TRAIN_HW, 1792, 1, "cpu")
    cpu_model = build_model(cut, device="cpu", dtype=torch.float32, seed=0)
    imgs = batch.dino_images[0]
    with torch.no_grad():
        want = segformer.seg_logits(cpu_model.segformer, imgs)
    gpu_model = _step_parity(env, "conf-parity", cpu_model, cut, batch, geo_start,
                             dict(PI3_GROUPS, conf=("conf_decoder.", "conf_head.")), _step_launches(cut),
                             dict(freeze_und=True), details=("local_conf_loss",))
    with torch.no_grad():
        got = segformer.seg_logits(gpu_model.segformer, imgs.to(dev)).cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    sky_g, sky_w = got.argmax(1) == 2, want.argmax(1) == 2
    print(f"[conf-parity] SegFormer logits {tuple(got.shape)} fp32, TF32 off: max|gpu-cpu|/max|cpu| {rel:.3e} "
          f"(budget 3e-2); arg-max class equal on {(got.argmax(1) == want.argmax(1)).float().mean().item():.6f} of "
          f"the pixels, sky mask on {(sky_g == sky_w).float().mean().item():.6f} ({sky_w.float().mean().item():.4f} "
          f"of them sky on the CPU)")
    if not rel <= 3e-2:
        _fail(f"conf parity: SegFormer logits off by {rel} (budget 3e-2)")
    if not all(p.grad is None for n_, p in gpu_model.named_parameters() if n_.startswith("Pi3Loss.")):
        _fail("conf parity: the frozen SegFormer got gradients")
    del cpu_model, gpu_model, batch, got, want
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 19b. the conf-head step at full width and depth --------------------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.float32, seed=0).train()
    optimizer = trainer.make_optimizer(
        model, schedule=trainer.warmup_cosine_schedule(0.0, 1e-4, 0, 1000), weight_decay=0.05,
        freeze_und=True, mu_dtype=torch.bfloat16, factored_v=True)
    state = trainer.init_train_state(model, optimizer, ema=True)
    batch, geo_start = train_torch.full_size_batch(cfg, TRAIN_VIEWS, TRAIN_HW, TRAIN_TOKENS, 0, dev)
    step_fn = trainer.make_train_step(cfg, compute_dtype=torch.bfloat16, ema_decay=0.9999, geo_start=geo_start)
    torch.cuda.synchronize()
    real_tokens = int((batch.doc_id[0] >= 0).sum().item())
    n_all = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in optimizer.params)
    n_conf = sum(p.numel() for n_, p in model.named_parameters() if n_.startswith(("conf_decoder.", "conf_head.")))
    print(f"[conf] fp32 init of {n_all / 1e9:.3f} B parameters ({n_train / 1e9:.3f} B trainable, {n_conf / 1e6:.1f} M "
          f"of them the conf decoder and head; the SegFormer's random weights from the seed, frozen), optimizer "
          f"and EMA on the card in {time.perf_counter() - t0:.1f} s ({card})")
    launches = _full_size_steps(
        env, "conf", state, step_fn, batch, real_tokens, _step_launches(cfg),
        f"--train_conf, {TRAIN_VIEWS} views {TRAIN_HW[0]}x{TRAIN_HW[1]}, {TRAIN_TOKENS}-row pack, SPLIT, "
        f"--freeze_und --factored_v --mu_dtype bfloat16, sky masks from the SegFormer in-program",
        always_frozen=("Pi3Loss.",))
    del model, optimizer, state, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[conf] phase 19 in {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches


def _dense_moe_phase(env, recon_ms):
    """Phase 20, the "moe" and "dense" decoder layers. Returns {path: launches} of the two full-size
    recon calls."""
    import gc

    import numpy as np
    import torch

    import train_torch
    from g2vlm_tpu_torch.config import G2VLMConfig, cut_depth_config
    from g2vlm_tpu_torch.inference import decoding
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
    from g2vlm_tpu_torch.ops import flash_attention as fa
    from g2vlm_tpu_torch.weights import build_model, init_moe_from_dense, load_checkpoint, save_safetensors

    dev, card = env.dev, env.card
    K1, K2 = "flash_batched_attention", "flash_segment_attention"
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()

    def with_layers(cfg, variant):
        return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, layer_module=variant))

    def counted(fn):
        fa.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, _launches(fa)

    # ---- 20a. the 32-view recon call with each layer module, MIXED prefill ------------------------
    frames = np.random.default_rng(0).integers(0, 256, (32, 294, 518, 3), dtype=np.uint8)
    paths = {}
    for variant in ("moe", "dense"):
        cfg = with_layers(G2VLMConfig(visual_und=False), variant)
        model = build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)
        pipe = G2VLMPipeline(model, cfg)
        torch.cuda.reset_peak_memory_stats()
        out, launches = counted(lambda: pipe.recon_from_frames(frames))
        want = {K1: cfg.dino.num_hidden_layers + cfg.pi3.depth * (2 + 2 * cfg.use_global_points),
                K2: cfg.llm.num_hidden_layers}
        if launches != want:
            _fail(f"recon {variant}: launches {launches}, expected {want}")
        for key in ("points", "local_points", "global_points", "camera_poses"):
            if not torch.isfinite(out[key]).all():
                _fail(f"recon {variant}: {key} is not finite")
        if tuple(out["points"].shape) != (32, 294, 518, 3):
            _fail(f"recon {variant}: points of shape {tuple(out['points'].shape)}")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            pipe.recon_from_frames(frames)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        print(f"[layers] recon_from_frames, layer_module={variant!r} (MIXED prefill of 25,088 rows), 32 views "
              f"294x518 bf16: {ms:.1f} ms per call (median of {[round(t, 1) for t in times]}; phase 6's 'mot' in "
              f"GEO_MAIN {recon_ms:.1f} ms), {32e3 / ms:.2f} frames/s, peak allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; outputs finite ({card})")
        paths["recon_" + variant] = launches
        del model, pipe, out
        gc.collect()
        torch.cuda.empty_cache()

    # ---- 20b. cut-depth parity of recon, the chat prefill and its first decode step -------------
    token_ids = dict(bos_token_id=1, eos_token_id=2, start_of_image=3, end_of_image=4)
    frames2 = np.random.default_rng(1).integers(0, 256, (2, 294, 518, 3), dtype=np.uint8)

    def chat_first_step(pipe, cut):
        prefill, hidden, kv, _, _ = pipe.chat_prefill(list(frames2), QUESTION, device_preprocess=True)
        dt = pipe.model.dtype
        cache = decoding.build_cache(kv, prefill.seq_len, cut.llm, len(prefill.doc_id) + 8, dtype=dt)
        logits, _ = decoding.decode_step(pipe.model.language_model, cache, pipe._start_token(),
                                         int(prefill.next_rope_pos), cut.llm, compute_dtype=dt)
        real = torch.as_tensor(prefill.doc_id >= 0)
        return {"prefill_hidden": hidden.float().cpu()[real], "first_step_logits": logits.float().cpu()}

    for variant in ("moe", "dense"):
        cut = cut_depth_config(with_layers(G2VLMConfig(), variant), 2)
        cpu_model = _tame_point_heads(build_model(cut, device="cpu", dtype=torch.float32, seed=0))
        cpu_pipe = G2VLMPipeline(cpu_model, cut, new_token_ids=token_ids)
        t0 = time.perf_counter()
        want = {**cpu_pipe.recon_from_frames(frames2), **chat_first_step(cpu_pipe, cut)}
        cpu_s = time.perf_counter() - t0
        gpu_model = build_model(cut, device=dev, dtype=torch.bfloat16, seed=None)
        gpu_model.load_state_dict(cpu_model.state_dict())
        pipe = G2VLMPipeline(gpu_model, cut, new_token_ids=token_ids)
        got, l_recon = counted(lambda: pipe.recon_from_frames(frames2))
        chat, l_chat = counted(lambda: chat_first_step(pipe, cut))
        got.update(chat)
        n_dino, n_llm = cut.dino.num_hidden_layers, cut.llm.num_hidden_layers
        if l_recon != {K1: n_dino + cut.pi3.depth * 4, K2: n_llm} or l_chat != {K1: n_dino, K2: cut.vit.depth + n_llm}:
            _fail(f"layers parity {variant}: launches recon {l_recon}, chat {l_chat}")
        rels = {}
        for key, w in want.items():
            a = got[key].float().cpu()
            rels[key] = ((a - w).abs().max() / w.abs().max()).item()
            if not torch.isfinite(a).all() or rels[key] > 3e-2:
                _fail(f"layers parity {variant}: {key} off by {rels[key]} (budget 3e-2)")
        print(f"[layers-parity] layer_module={variant!r}, cut depth, 2 views: max|gpu-cpu|/max|cpu| "
              + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
              + f" (budget 3e-2); launches recon {l_recon}, chat prefill + first step {l_chat}; cpu fp32 {cpu_s:.1f} s")
        del cpu_model, cpu_pipe, gpu_model, pipe, got, want
        gc.collect()
        torch.cuda.empty_cache()

    # ---- 20c. --model_path <cut checkpoint> --bootstrap_moe: one step, card vs CPU --------------
    # train_torch.py loads the checkpoint, copies the base expert into the geo expert and trains; its
    # load_tokenizer needs `transformers`, which the card's machine may lack, so its calls run here in
    # process: load_checkpoint, init_moe_from_dense, then the recon-stage step of phase 9
    work = tempfile.mkdtemp(prefix="g2vlm_bootstrap_")
    full = G2VLMConfig()
    cut = dataclasses.replace(cut_depth_config(full, 2), pi3=full.pi3)  # the config files hold no Pi3 field
    save_safetensors(os.path.join(work, "model.safetensors"),
                     build_model(cut, device="cpu", dtype=torch.bfloat16, seed=3).state_dict())
    for name, sub in (("text_config.json", cut.llm), ("vit_config.json", cut.vit), ("dino_config.json", cut.dino)):
        with open(os.path.join(work, name), "w") as f:
            json.dump(dataclasses.asdict(sub), f)
    cpu_model, ccfg = load_checkpoint(work, device="cpu", dtype=torch.float32)
    init_moe_from_dense(cpu_model)
    sd = cpu_model.state_dict()
    if not all(torch.equal(v, sd[k.replace("_moe_geo", "")]) for k, v in sd.items() if "_moe_geo" in k):
        _fail("bootstrap: a geo leaf is not a copy of its base leaf")
    batch, geo_start = train_torch.full_size_batch(ccfg, 2, TRAIN_HW, 1792, 1, "cpu")
    gpu_model = _step_parity(env, "bootstrap-parity", cpu_model, ccfg, batch, geo_start, PI3_GROUPS,
                             _step_launches(ccfg), dict(freeze_und=True))
    loaded, _ = load_checkpoint(work, device=dev, dtype=torch.float32)
    init_moe_from_dense(loaded)
    if not all(torch.equal(v.cpu(), sd[k]) for k, v in loaded.state_dict().items()):
        _fail("bootstrap: the card's load + init_moe_from_dense differs from the CPU's")
    print(f"[layers] --bootstrap_moe on a cut 'mot' checkpoint ({len(sd)} tensors): every geo leaf a copy of its "
          f"base leaf, the card's load bitwise the CPU's; phase 20 in {time.perf_counter() - t_phase:.1f} s ({card})")
    del cpu_model, gpu_model, loaded, sd
    shutil.rmtree(work)
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def _dinov3_phase(env, recon_ms):
    """Phase 21, the DINOv3 geometry tower. Returns the kernels' launches of the full-size recon
    call."""
    import gc

    import numpy as np
    import torch

    from g2vlm_tpu_torch.config import Dinov3Config, G2VLMConfig, cut_depth_config
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
    from g2vlm_tpu_torch.ops import flash_attention as fa
    from g2vlm_tpu_torch.weights import build_model

    dev, card = env.dev, env.card
    K1, K2 = "flash_batched_attention", "flash_segment_attention"
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(G2VLMConfig(visual_und=False), use_dinov3=True, dinov3=Dinov3Config())
    width = 512  # 294x518 frames -> 288x512 views, 18 x 32 patches of 16

    def recon_launches(c):
        return {K1: c.dinov3.num_hidden_layers + c.pi3.depth * (2 + 2 * c.use_global_points),
                K2: c.llm.num_hidden_layers}

    # ---- 21a. cut-depth parity of the recon call --------------------------------------------------
    cut = cut_depth_config(cfg, 2)
    token_ids = dict(bos_token_id=1, eos_token_id=2, start_of_image=3, end_of_image=4)
    frames2 = np.random.default_rng(1).integers(0, 256, (2, 294, 518, 3), dtype=np.uint8)
    cpu_model = _tame_point_heads(build_model(cut, device="cpu", dtype=torch.float32, seed=0))
    want = G2VLMPipeline(cpu_model, cut, new_token_ids=token_ids).recon_from_frames(frames2, new_width=width)
    gpu_model = build_model(cut, device=dev, dtype=torch.bfloat16, seed=None)
    gpu_model.load_state_dict(cpu_model.state_dict())
    fa.reset_launch_counts()
    got = G2VLMPipeline(gpu_model, cut, new_token_ids=token_ids).recon_from_frames(frames2, new_width=width)
    torch.cuda.synchronize()
    launches = _launches(fa)
    if launches != recon_launches(cut):
        _fail(f"dinov3 parity: launches {launches}, expected {recon_launches(cut)}")
    rels = {}
    for key in ("local_points", "camera_poses", "global_points", "points"):
        a, b = got[key].float().cpu(), want[key]
        rels[key] = ((a - b).abs().max() / b.abs().max()).item()
        if not torch.isfinite(a).all() or rels[key] > 3e-2:
            _fail(f"dinov3 parity: {key} off by {rels[key]} (budget 3e-2)")
    print(f"[dinov3-parity] cut depth, 2 views of 288x512: max|gpu-cpu|/max|cpu| "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()) + f" (budget 3e-2); launches {launches}")
    del cpu_model, gpu_model, got, want

    # ---- 21b. the 32-view recon call with the DINOv3 tower at full size ------------------------------
    model = build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    pipe = G2VLMPipeline(model, cfg)
    frames = np.random.default_rng(0).integers(0, 256, (32, 294, 518, 3), dtype=np.uint8)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    out = pipe.recon_from_frames(frames, new_width=width)
    torch.cuda.synchronize()
    launches = _launches(fa)
    if launches != recon_launches(cfg):
        _fail(f"dinov3 recon: launches {launches}, expected {recon_launches(cfg)}")
    for key in ("points", "local_points", "global_points", "camera_poses"):
        if not torch.isfinite(out[key]).all():
            _fail(f"dinov3 recon: {key} is not finite")
    if tuple(out["points"].shape) != (32, 288, 512, 3):
        _fail(f"dinov3 recon: points of shape {tuple(out['points'].shape)}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipe.recon_from_frames(frames, new_width=width)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    rows = len(pipe.build_recon_prefill(32, 18, 32).doc_id)
    print(f"[dinov3] recon_from_frames(new_width={width}), use_dinov3 with Dinov3Config() (ViT-L/16: "
          f"{cfg.dinov3.num_hidden_layers} layers, {cfg.dinov3.hidden_size} wide, {cfg.dinov3.num_attention_heads} "
          f"heads of {cfg.dinov3.head_dim}, {cfg.dinov3.num_register_tokens} registers), 32 views 288x512 bf16, a prefill of {rows} rows: "
          f"{ms:.1f} ms per call (median of {[round(t, 1) for t in times]}; phase 6's DINOv2 at 294x518 "
          f"{recon_ms:.1f} ms), {32e3 / ms:.2f} frames/s, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; outputs finite; phase 21 in "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    del model, pipe, out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# phase 22: configs/joint_train.yaml's three groups (its order, weights, mandatory flags and transform
# arguments) over data that `make_joint_train_data` writes from a seed: 2 scenes of 8 frames of 480x640
# (recon); 4 SPAR rows of 2 views of 480x640 with 240x320 depth maps, scannet and structured3d in turn
# (recon_then_und); 3 image conversations of 480x640 and a video row whose 4 <image> tags take 4 frames of
# 294x518 from a folder of 8 (vlm_sft). The repo holds no statistics of SPAR's or LLaVA's text lengths, so
# the texts are short: a question of 24 words and an answer of 12 (a word is a token without a tokenizer).
# A 12,800-token pack then has room for more ViT images than 22(b)'s 23,328 slots hold (8 of 2,916 rows):
# the port's packer closes a pack before a sample whose images would overflow them (ROADMAP C)
THREE_GROUP_DATA = dict(target_size=518, vit_hw=(768, 768), n_scenes=2, n_frames=8, scene_hw=(480, 640),
                        n_spar_rows=4, spar_hw=(480, 640), spar_depth_hw=(240, 320), n_chats=3, image_hw=(480, 640),
                        n_video_frames=8, video_hw=(294, 518), frames_per_video=4, question_words=24,
                        answer_words=12, seed=0)
THREE_GROUP_STEPS = 4  # 22(b): steps fed inline, then as many through the loader
VIDEO_FRAMES, VIDEO_FOLDER_FRAMES = 8, 64  # 22(c)


def _same_tree(got, want) -> bool:
    """Equal structure, types and values; numpy arrays bitwise with their dtypes."""
    import numpy as np

    if isinstance(want, np.ndarray):
        return (isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
                and np.array_equal(got, want))
    if isinstance(want, dict):
        return isinstance(got, dict) and set(got) == set(want) and all(_same_tree(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return type(got) is type(want) and len(got) == len(want) and all(map(_same_tree, got, want))
    return type(got) is type(want) and got == want


def _three_group_phases(env, joint):
    """Phase 22: the three groups of configs/joint_train.yaml; (b) first, on phase 17's model and state
    (`joint`), which it then frees. Returns the launches of 22(b)'s steps and of one 22(c) video chat
    call."""
    import pyarrow
    import yaml

    from g2vlm_tpu_torch.data.synthetic import make_joint_train_data

    card = env.card
    work = tempfile.mkdtemp(prefix="g2vlm_three_")
    t_phase = time.perf_counter()
    data = os.path.join(work, "data")
    os.makedirs(data)
    t0 = time.perf_counter()
    data_cfg = make_joint_train_data(data, **THREE_GROUP_DATA)
    with open(os.path.join(REPO_ROOT, "configs", "joint_train.yaml")) as f:
        joint_yaml = yaml.safe_load(f)

    def knobs(group):
        return {k: v for k, v in group.items() if k not in ("dataset_names", "dataset_info")}

    if list(data_cfg) != list(joint_yaml) or any(knobs(data_cfg[g]) != knobs(joint_yaml[g]) for g in joint_yaml):
        _fail(f"three groups: the written config {data_cfg} is not configs/joint_train.yaml's {joint_yaml}")
    print(f"[three] configs/joint_train.yaml's groups {list(joint_yaml)} (weights, mandatory flags, transform "
          f"arguments equal) over data written from seed {THREE_GROUP_DATA['seed']} in {time.perf_counter() - t0:.1f}"
          f" s: SPAR rows as parquet (pyarrow {pyarrow.__version__}, PyYAML {yaml.__version__}) ({card})")
    paths = {"three_group_step": _three_group_steps(env, data_cfg, joint)}
    _three_group_resume(env, data_cfg, work)
    paths["video_chat"] = _video_chat(env, os.path.join(work, "video"))
    shutil.rmtree(work)
    print(f"[three] phase 22 in {time.perf_counter() - t_phase:.1f} s ({card})")
    return paths


def _three_group_resume(env, data_cfg, work):
    """Phase 22(a): train_torch.py --data_config over the three groups at phase 18's cut depth and flags,
    run A against run B resumed; then, in process, the CE of each group's answer tokens on run A's first
    pack, from run A's initial weights."""
    import dataclasses
    import gc

    import torch
    import yaml

    import train_torch
    from g2vlm_tpu_torch.config import G2VLMConfig, cut_depth_config
    from g2vlm_tpu_torch.train import trainer
    from g2vlm_tpu_torch.weights import build_model

    dev, card = env.dev, env.card
    t_phase = time.perf_counter()
    path = os.path.join(work, "joint.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(data_cfg, f)
    # packs close once they hold 2,000 tokens, so a pack is the two mandatory samples and at most one drawn
    # one: at most 6 ViT images (the two recon_then_und views, the video row's 4 frames) of 2,916 rows
    common = ["--data_config", path, "--cut_depth", "2", "--max_vit_patches", str(6 * VIT_ROWS_PER_IMAGE),
              "--max_num_tokens", "16384", "--expected_num_tokens", "2000", "--image_num_range", "2", "4",
              "--split_layout", "--freeze_recon", "--factored_v", "--mu_dtype", "bfloat16", "--ckpt_every", "2",
              "--log_every", "1"]
    got_a, worst, t_runs = _resume_runs(common, work, "three groups resume")
    status = json.load(open(os.path.join(work, "ckA", "data_status_4.json")))
    cursor = status.get("tiny_spar", {}).get("0")
    if not (isinstance(cursor, list) and len(cursor) == 3):
        _fail(f"three groups resume: no parquet cursor [file, row group, row] in the data status: {status}")
    print(f"[three] train_torch.py --data_config (the three groups) --cut_depth 2 --split_layout --freeze_recon "
          f"--max_vit_patches {6 * VIT_ROWS_PER_IMAGE}, subprocesses with PYTHONHASHSEED=0: A 4 steps, B 2 steps then "
          f"--resume for 2, all in {t_runs:.1f} s; steps 2-3 of B against A: worst metric {worst:.2e} relative "
          f"(budget 1e-3); data_status equal, parquet cursor {cursor}; A's steps "
          + "; ".join(f"{s}: " + " ".join(f"{k} {v}" for k, v in got_a[s].items() if k != "time") for s in range(4))
          + f" ({card})")

    # the first pack of run A's stream (its flags, seed and initial weights), each group's answer tokens alone
    # in the CE; the text ids differ from the run's (this process's hash seed), the pack's layout does not
    args = train_torch.parse_args(common + ["--steps", "1"])
    cut = cut_depth_config(G2VLMConfig(visual_und=True), 2)
    model = build_model(cut, device=dev, dtype=torch.float32, seed=args.seed).train()
    batch, geo_start, dixs, _ = next(train_torch.packer_batches(args, data_cfg, cut, None, None, None, dev))
    one = batch.map(lambda x: x[0])
    group_of = {ds: g for g, gcfg in data_cfg.items() for ds in gcfg["dataset_names"]}
    sample_group = [group_of[d["dataset_name"]] for d in dixs]
    slot_group = [sample_group[int(s)] for s in one.doc_id[one.ce_indexes.long()].tolist()]
    results = {}
    with torch.no_grad():
        for g in ["all"] + sorted(set(sample_group)):
            keep = torch.tensor([g in ("all", sg) for sg in slot_group], device=dev)
            w = one.ce_weights * keep
            if not (w > 0).any():
                results[g] = "no answer tokens"
                continue
            loss, det = trainer.train_forward(model, dataclasses.replace(one, ce_weights=w), cut,
                                              compute_dtype=torch.bfloat16, geo_start=geo_start)
            if not (torch.isfinite(loss) and torch.isfinite(det["ce"])):
                _fail(f"three groups: group {g}: loss {loss.item()} ce {det['ce'].item()}")
            results[g] = f"ce {det['ce'].item():.4f} over {int((w > 0).sum())} answer tokens"
            if g == "all":
                results[g] += ", loss " + " ".join(f"{k} {v.item():.4f}" for k, v in det.items())
            elif g == "recon_then_und" and not det["ce"].item() > 0:
                _fail(f"three groups: the recon_then_und answers give ce {det['ce'].item()}")
    if "recon_then_und" not in results:
        _fail(f"three groups: run A's first pack holds no recon_then_und sample: {sample_group}")
    print(f"[three] run A's first pack ({len(dixs)} samples: {sample_group}), cut depth on the card, bf16: "
          + "; ".join(f"{g}: {r}" for g, r in results.items()) + f"; 22(a) in {time.perf_counter() - t_phase:.1f} s "
          f"({card})")
    del model, batch, one
    gc.collect()
    torch.cuda.empty_cache()


class _WordIds:
    """A tokenizer stand-in that gives every process the same ids, one a word: the datasets' tokenizer-less
    ids, hash(word) % 5000 + 100, are salted per process, and a spawned loader worker is another process."""

    def encode(self, text):
        return [zlib.crc32(w.encode()) % 5000 + 100 for w in text.split()]


def _three_group_stream(data_cfg, ids, packer_cfg, worker_id=0):
    """A fresh pack stream over the three groups, its datasets built in the caller's thread or process;
    module-level, so that a spawned loader worker can unpickle it. It touches no CUDA state."""
    import random

    from g2vlm_tpu_torch.data.packing import PackedIterableDataset
    from g2vlm_tpu_torch.data.registry import build_groups_from_config

    return iter(PackedIterableDataset(build_groups_from_config(data_cfg, tokenizer=_WordIds()), ids, packer_cfg,
                                      group_rng=random.Random(0)))


def _timed_three_group_stream(data_cfg, ids, packer_cfg, worker_id=0):
    """_three_group_stream's packs as (pack, ms its worker took to build it, time.monotonic() when it was
    built): the monotonic clock is the machine's, the same in every process."""
    it = _three_group_stream(data_cfg, ids, packer_cfg, worker_id)
    while True:
        t0 = time.perf_counter()
        pack = next(it)
        yield pack, (time.perf_counter() - t0) * 1e3, time.monotonic()


def _pipe_sink(conn):
    """Receives byte strings until an empty one and answers each with its length: the far end of
    22(b)'s probe of a bare pipe."""
    while True:
        blob = conn.recv_bytes()
        if not blob:
            return
        conn.send(len(blob))


def _bare_pipe_ms(blobs):
    """ms to move each byte string through a pipe to a spawned process that does nothing else, and
    back its length."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    here, there = ctx.Pipe()
    sink = ctx.Process(target=_pipe_sink, args=(there,), daemon=True)
    sink.start()
    here.send_bytes(b"x")  # the sink is up
    here.recv()
    times = []
    for blob in blobs:
        t0 = time.perf_counter()
        here.send_bytes(blob)
        if here.recv() != len(blob):
            _fail("22(b): the bare pipe lost bytes")
        times.append((time.perf_counter() - t0) * 1e3)
    here.send_bytes(b"")
    sink.join(30)
    if sink.is_alive():
        sink.terminate()
    return times


def _three_group_steps(env, data_cfg, joint):
    """Phase 22(b): phase 17's step (G2VLMConfig() at full width and depth, its flags, 12,800-row packs,
    23,328 ViT slots) on its model and train state, on packs that PackedIterableDataset draws from the
    three groups at joint_train.yaml's sizes, as train_torch.packer_batches configures it (text ids from
    _WordIds): THREE_GROUP_STEPS steps fed inline (draw a pack on the host, then step), then as many fed
    through a one-worker PrefetchLoader (a thread) and as many through a one-worker
    ProcessPrefetchLoader (a spawned process), whose packs must equal the inline ones. Each worker times
    its packs. For the process, the time from a pack built and asked for to received is set beside the
    unpickling and pickling this process times on the same packs and beside one pack's bytes moved
    through a bare pipe to a spawned process that does nothing else. Frees `joint`'s model and state;
    returns the launches of all the steps."""
    import gc
    import pickle
    from multiprocessing.reduction import ForkingPickler

    import torch

    import train_torch
    from g2vlm_tpu_torch.data.packing import PackerConfig
    from g2vlm_tpu_torch.train import trainer
    from g2vlm_tpu_torch.train.dataloader import PrefetchLoader, ProcessPrefetchLoader

    dev, card = env.dev, env.card
    t_phase = time.perf_counter()
    cfg, state = joint.cfg, joint.state
    v = cfg.llm.vocab_size
    ids = dict(bos_token_id=v - 4, eos_token_id=v - 3, start_of_image=v - 2, end_of_image=v - 1)
    cap = VIT_TRAIN_IMAGES * VIT_ROWS_PER_IMAGE
    packer_cfg = PackerConfig(expected_num_tokens=TRAIN_TOKENS * 8 // 9, max_num_tokens_per_sample=TRAIN_TOKENS // 2,
                              max_num_tokens=TRAIN_TOKENS, image_num_range=(2, 3), sorted_layout=True,
                              geo_start_bucket=256, max_vit_patches=cap)

    torch.cuda.reset_peak_memory_stats()
    checks = _StepChecks("three-group", state)
    step_fns = {}

    def run_step(state, b):
        """One step on pack `b`, its launches held to those derived from the pack; returns (state, ms,
        metrics), ms from the upload of the pack to the step's end."""
        gs = b["geo_start"]
        if gs not in step_fns:  # one step function per geo_start, as train_torch.py keeps them
            step_fns[gs] = trainer.make_train_step(cfg, compute_dtype=torch.bfloat16, ema_decay=0.9999, geo_start=gs)
        t0 = time.perf_counter()
        state, metrics, _ = checks.step(step_fns[gs], state, train_torch.batch_from_pack(b, dev),
                                        _step_launches(cfg, vit=bool(b["vit_grids"]), freeze_recon=True))
        return state, (time.perf_counter() - t0) * 1e3, metrics

    def describe(b):
        groups = {}
        for d in b["data_indexes"]:
            groups[d["dataset_name"]] = groups.get(d["dataset_name"], 0) + 1
        return (f"{int((b['doc_id'] >= 0).sum())} tokens, {len(b['dino_images'])} views of "
                f"{b['dino_images'].shape[2]}x{b['dino_images'].shape[3]}, {len(b['vit_grids'])} ViT images "
                f"({int((b['vit_seg'] >= 0).sum())} of {cap} slots), samples {groups}")

    def rounded(ts):
        return [round(t, 1) for t in ts]

    # inline: draw a pack on the host, then step
    n = THREE_GROUP_STEPS
    inline, host_ms, inline_ms = [], [], []
    it = _three_group_stream(data_cfg, ids, packer_cfg)
    torch.cuda.synchronize()
    t_wall = time.perf_counter()
    for i in range(n):
        t0 = time.perf_counter()
        inline.append(next(it))
        host_ms.append((time.perf_counter() - t0) * 1e3)
        state, ms, metrics = run_step(state, inline[-1])
        inline_ms.append(ms)
        print(f"[three] inline step {i}: pack {host_ms[-1]:.1f} ms ({describe(inline[-1])}), step {ms:.1f} ms, loss "
              f"{metrics['loss'].item():.4f} ce {metrics['ce'].item():.4f}")
    wall_inline = (time.perf_counter() - t_wall) * 1e3
    real = sum(int((b["doc_id"] >= 0).sum()) for b in inline)
    # through the loaders: one worker thread, then one spawned worker process (no interpreter lock shared with
    # the stepping thread), packs the same stream while the card steps
    make_iter = functools.partial(_timed_three_group_stream, data_cfg, ids, packer_cfg)
    for name, loader in (("PrefetchLoader", PrefetchLoader(make_iter, num_workers=1, prefetch=2)),
                         ("ProcessPrefetchLoader", ProcessPrefetchLoader(make_iter, num_workers=1, prefetch=2))):
        packs, build_ms, wait_ms, arrive_ms, step_ms = [], [], [], [], []
        lit = iter(loader)
        t_wall = time.perf_counter()
        try:
            for i in range(n):
                t_ask = time.monotonic()
                pack, built_ms, built_at = next(lit)
                t_got = time.monotonic()
                packs.append(pack)
                build_ms.append(built_ms)
                wait_ms.append((t_got - t_ask) * 1e3)
                arrive_ms.append((t_got - max(t_ask, built_at)) * 1e3)  # from built and asked for to received
                state, ms, metrics = run_step(state, pack)
                step_ms.append(ms)
                print(f"[three] {name} step {i}: waited {wait_ms[-1]:.1f} ms for the pack, which the worker built in "
                      f"{built_ms:.1f} ms and which took {arrive_ms[-1]:.1f} ms from built and asked for to received; "
                      f"step {ms:.1f} ms, loss {metrics['loss'].item():.4f}")
            wall = (time.perf_counter() - t_wall) * 1e3
        finally:
            loader.close()  # the worker ends once its current pack is built; no pack stays queued
        if not all(_same_tree(g, w) for g, w in zip(packs, inline)):
            _fail(f"three-group step: the packs of {name} differ from the inline packs")
        where = ""
        if name == "ProcessPrefetchLoader":  # a pack's crossing taken apart, on the same packs
            blobs = [ForkingPickler.dumps(b) for b in packs]
            dump_ms, load_ms = [], []
            for b, blob in zip(packs, blobs):
                t0 = time.perf_counter()
                ForkingPickler.dumps(b)
                dump_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                pickle.loads(blob)
                load_ms.append((time.perf_counter() - t0) * 1e3)
            mib = [len(blob) / 2**20 for blob in blobs]
            bare_ms = _bare_pipe_ms(blobs[1:2])  # one pack: ~9 s for 140 MiB on the H100 host (PERF.md §6)
            del blobs
            rest_ms = [a - l_ for a, l_ in zip(arrive_ms, load_ms)]
            where = (f"; a pack crosses the queue as {rounded(mib)} MiB pickled; in this process pickling it takes "
                     f"{rounded(dump_ms)} ms (the worker's feeder thread pickles a pack before it is asked for, "
                     f"but for the first) and unpickling {rounded(load_ms)} ms, which leaves {rounded(rest_ms)} ms "
                     f"of each arrival to the pipe ({sum(mib[1:]) / max(sum(rest_ms[1:]), 1e-3) * 1e3:.1f} MiB/s over "
                     f"steps 1-{n - 1}); pack 1's bytes through a bare pipe to an idle spawned process "
                     f"{bare_ms[0]:.1f} ms ({mib[1] / bare_ms[0] * 1e3:.1f} MiB/s)")
        print(f"[three] {name}(num_workers=1): {wall / n:.1f} ms per step wall (steps {rounded(step_ms)} ms, waits "
              f"for a pack {rounded(wait_ms)} ms; the worker built its packs in {rounded(build_ms)} ms, inline "
              f"{rounded(host_ms)}; from built and asked for to received {rounded(arrive_ms)} ms), "
              f"{real / wall * 1e3:.1f} real tokens/s; it hides {wall_inline - wall:.1f} ms of {n} steps "
              f"({(wall_inline - wall) / n:.1f} ms a step); its packs equal the inline packs array for array{where} "
              f"({card})")
        del packs
    checks.frozen_unchanged(state)
    print(f"[three] G2VLMConfig(), phase 17's model, state and flags, {n} packs of {TRAIN_TOKENS} rows from the three "
          f"groups ({real} real tokens): host {statistics.median(host_ms):.1f} ms per pack (median of "
          f"{rounded(host_ms)}); inline {wall_inline / n:.1f} ms per step wall (steps {rounded(inline_ms)} ms), "
          f"{real / wall_inline * 1e3:.1f} real tokens/s; peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; {len(checks.probe)} sampled frozen leaves and their EMA bitwise unchanged; launches of the {3 * n} "
          f"steps {checks.total}, each step's as derived from its pack: K3 {2 * cfg.llm.num_hidden_layers} at head "
          f"dim {cfg.llm.hidden_size // cfg.llm.num_attention_heads} + {2 * cfg.vit.depth} at "
          f"{cfg.vit.embed_dim // cfg.vit.num_heads}, K5 {cfg.llm.num_hidden_layers} + {cfg.vit.depth} dq and dkv at "
          f"the same, K6 / K7 in the Pi3 heads, K1 in the frozen DINOv2 ({card})")
    total = checks.total
    joint.model = joint.optimizer = joint.state = None  # phase 17's state, freed for 22(a) and 22(c)
    del state, step_fns, checks, inline, metrics
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[three] 22(b) in {time.perf_counter() - t_phase:.1f} s ({card})")
    return total


def _video_chat(env, folder):
    """Phase 22(c): G2VLMConfig() with random bf16 weights answers on VIDEO_FRAMES frames that
    sample_video_frames takes (mode="middle") from a folder of VIDEO_FOLDER_FRAMES PNGs of 294x518, for 32
    new tokens; then infer_chat_torch.py --video on the folder. Returns one call's launches."""
    import gc

    import numpy as np
    import torch
    from PIL import Image

    from g2vlm_tpu_torch.config import G2VLMConfig
    from g2vlm_tpu_torch.data.video import read_frames_folder, sample_frame_indices, sample_video_frames
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
    from g2vlm_tpu_torch.models import qwen_vit
    from g2vlm_tpu_torch.ops import flash_attention as fa
    from g2vlm_tpu_torch.weights import build_model

    dev, card = env.dev, env.card
    t_phase = time.perf_counter()
    os.makedirs(folder)
    rng = np.random.default_rng(22)
    for i in range(VIDEO_FOLDER_FRAMES):
        Image.fromarray(rng.integers(0, 256, (294, 518, 3), dtype=np.uint8)).save(os.path.join(folder, f"{i:04d}.png"))
    t0 = time.perf_counter()
    frames = sample_video_frames(folder, VIDEO_FRAMES, mode="middle")
    t_frames = (time.perf_counter() - t0) * 1e3
    picked = sample_frame_indices(VIDEO_FRAMES, VIDEO_FOLDER_FRAMES, "middle")
    direct = [np.asarray(Image.open(os.path.join(folder, f"{i:04d}.png")).convert("RGB")) for i in picked]
    again = read_frames_folder(folder, VIDEO_FRAMES, "middle")
    if not all(np.array_equal(np.asarray(a), b) and np.array_equal(np.asarray(c), b)
               for a, b, c in zip(frames, direct, again)) or len(frames) != VIDEO_FRAMES:
        _fail("video chat: the sampled frames are not read_frames_folder's / the PNGs at the bin centres")

    cfg = G2VLMConfig()
    model = build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    pipe = G2VLMPipeline(model, cfg)
    vocab = cfg.llm.vocab_size
    # the host path: 8 ViT images of 54 x 54 patch rows, in the row chunks packed_row_chunks picks
    rows = VIDEO_FRAMES * VIT_ROWS_PER_IMAGE
    vit_chunks = qwen_vit.packed_row_chunks(np.repeat(np.arange(VIDEO_FRAMES), VIT_ROWS_PER_IMAGE))
    K1, K2 = "flash_batched_attention", "flash_segment_attention"
    want = {K1: cfg.dino.num_hidden_layers, K2: cfg.vit.depth * vit_chunks + cfg.llm.num_hidden_layers}
    torch.cuda.reset_peak_memory_stats()
    infos, walls = [], []
    for _ in range(4):  # a cold call, then three
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, info = pipe.chat(frames, QUESTION, max_new_tokens=32, return_info=True)
        walls.append((time.perf_counter() - t0) * 1e3)
        launches = _launches(fa)
        ids = info["token_ids"]
        if launches != want:
            _fail(f"video chat: launches {launches}, expected {want}")
        if not ids or not all(0 <= t < vocab for t in ids):
            _fail(f"video chat: token ids {ids}")
        infos.append(info)
    if any(i["token_ids"] != infos[1]["token_ids"] for i in infos[1:]):
        _fail(f"video chat: the warm calls gave other ids: {[i['token_ids'] for i in infos]}")

    def med(key):
        return statistics.median(i[key] for i in infos[1:]) * 1e3

    host = statistics.median(w - (i["t_prefill_s"] + i["t_decode_s"]) * 1e3 for w, i in zip(walls[1:], infos[1:]))
    n_tok = infos[1]["num_tokens"]
    print(f"[video] {VIDEO_FRAMES} frames (mode=middle, indices {picked}) of a folder of {VIDEO_FOLDER_FRAMES} PNGs of "
          f"294x518, sampled in {t_frames:.1f} ms, equal to read_frames_folder's and to the PNGs; G2VLMConfig() "
          f"random bf16, the host preprocess (PIL), prefill {infos[1]['prefill_len']} rows ({rows} ViT patch rows in "
          f"{vit_chunks} row chunks), medians of 3 warm calls: TTFT {med('t_prefill_s'):.1f} ms = upload "
          f"{med('t_upload_s'):.1f} + prefill forward {med('t_forward_s'):.1f} + cache build {med('t_cache_s'):.1f}, "
          f"after {host:.1f} ms of host preprocess (call wall {statistics.median(walls[1:]):.1f} ms); decode "
          f"{med('t_decode_s') / n_tok:.3f} ms per token ({n_tok} tokens); peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches per call {launches} (K2: "
          f"{cfg.vit.depth * vit_chunks} at head dim {cfg.vit.embed_dim // cfg.vit.num_heads} in the ViT, "
          f"{cfg.llm.num_hidden_layers} at {cfg.llm.hidden_size // cfg.llm.num_attention_heads} in the prefill); "
          f"ids in the vocabulary, repeatable: {infos[1]['token_ids'][:8]}... ({card})")
    del model, pipe
    gc.collect()
    torch.cuda.empty_cache()

    # the entry point at full size (the tiny config's head dim of 16 has no kernel on the card)
    (t_cli, out), = _run_tools(["infer_chat_torch.py", "--video", folder, "--num_frames", str(VIDEO_FRAMES),
                                "--max_length", "8"])
    answer = out.strip().splitlines()[-1] if out.strip() else ""
    if not answer or not all(w.isdigit() for w in answer.split()):
        _fail(f"infer_chat_torch.py --video: no answer in {out[-1000:]}")
    print(f"[video] infer_chat_torch.py --video <folder of {VIDEO_FOLDER_FRAMES}> --num_frames {VIDEO_FRAMES} "
          f"--max_length 8 (G2VLMConfig(), random bf16 weights): exit 0 in {t_cli:.1f} s wall, answer {answer!r}; "
          f"22(c) in {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches



def _free_port() -> int:
    import socket

    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        return s_.getsockname()[1]


def _parallel_phase(env):
    """Phase 23: the multi-GPU layer on the card. (a) Phase 10's step at full width through FSDP2 on a
    one-rank NCCL group (`make_mesh(1, dp=1, fsdp=1, tp=1)`, `shard_model`): the first loss against phase
    10's, launches, frozen leaves; (b) K3 / K5 at the shapes sequence parallelism gives them (a query shard
    of S / n rows against the whole K / V, for each rank r of n in {2, 4}) and K2 at the recon prefill's,
    held against the unsharded launch (`_sp_shard_kernels`); (c) with two cards or more, the cut-depth step on
    2 NCCL ranks (fsdp=2, --sequence_parallel) against one rank. Returns the launches of (a) and of (b)'s shards."""
    import torch
    import torch.distributed as dist

    import train_torch
    from g2vlm_tpu_torch.config import G2VLMConfig
    from g2vlm_tpu_torch.parallel.mesh import make_mesh, shard_model
    from g2vlm_tpu_torch.train import trainer
    from g2vlm_tpu_torch.weights import build_model

    dev, card = env.dev, env.card
    t_phase = time.perf_counter()
    cfg = G2VLMConfig(visual_und=False)
    batch, geo_start = train_torch.full_size_batch(cfg, TRAIN_VIEWS, TRAIN_HW, TRAIN_TOKENS, 0, dev)
    real_tokens = int((batch.doc_id[0] >= 0).sum().item())

    # ---- (a) phase 10's step through FSDP2 on one NCCL rank ----
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev, dtype=torch.float32, seed=0).train()
        shard_model(model, make_mesh(1, dp=1, fsdp=1, tp=1, device_type="cuda"))
        optimizer = trainer.make_optimizer(
            model, schedule=trainer.warmup_cosine_schedule(0.0, 1e-4, 0, 1000), weight_decay=0.05,
            freeze_und=True, mu_dtype=torch.bfloat16, factored_v=True)
        state = trainer.init_train_state(model, optimizer, ema=True)
        step_fn = trainer.make_train_step(cfg, compute_dtype=torch.bfloat16, ema_decay=0.9999, geo_start=geo_start)
        torch.cuda.synchronize()
        print(f"[fsdp] fp32 init, fully_shard (28 decoder layers + the root) on a one-rank NCCL mesh, optimizer "
              f"and EMA in {time.perf_counter() - t0:.1f} s")
        fsdp_launches = _full_size_steps(
            env, "train-fsdp", state, step_fn, batch, real_tokens, _step_launches(cfg),
            f"phase 10's step through FSDP2 / DTensor on one NCCL rank, {TRAIN_VIEWS} views "
            f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, {TRAIN_TOKENS}-row pack")
        del model, optimizer, state, step_fn
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    ref, got = env.steps["train"], env.steps["train-fsdp"]
    rel = abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    print(f"[fsdp] first loss {got['losses'][0]!r} against phase 10's {ref['losses'][0]!r}: rel {rel:.3e} "
          f"(budget 1e-3), bitwise equal: {got['losses'][0] == ref['losses'][0]}; losses {got['losses']} against "
          f"{ref['losses']}; {got['ms']:.1f} ms per step against {ref['ms']:.1f} ({got['ms'] / ref['ms']:.3f}x), "
          f"{got['tokens_per_s']:.1f} real tokens/s against {ref['tokens_per_s']:.1f}, peak {got['peak_gib']:.2f} GiB "
          f"against {ref['peak_gib']:.2f} ({card})")
    if not rel <= 1e-3:
        _fail(f"phase 23(a): the FSDP step's first loss is off phase 10's by {rel} (budget 1e-3)")

    # ---- (b) the kernels at sequence-parallel shapes ----
    shard_counts = _sp_shard_kernels(env, cfg, batch)

    # ---- (c) two NCCL ranks, where the machine has two cards ----
    if torch.cuda.device_count() >= 2:
        _two_rank_step()
    else:
        print(f"[phase 23c] not run: {torch.cuda.device_count()} GPU")
    print(f"[parallel] phase 23 in {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"train_step_fsdp": fsdp_launches, "sp_shards": shard_counts}


def _sp_shard_kernels(env, cfg, batch):
    """Phase 23(b): for each rank r of n in {2, 4}, the body `sp_attender` runs on it, on one card: the public
    wrapper (`segment_attention` with `segment_plan(shard, whole)`) on query shard r of phase 10's pack against
    its whole K / V, K3 and then K5 under autograd, and K2 on a shard of the recon prefill; held against the
    kernels' unsharded launch. Returns the shards' launches."""
    import torch

    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
    from g2vlm_tpu_torch.ops import flash_attention as fa
    from g2vlm_tpu_torch.ops.attention import segment_attention
    from g2vlm_tpu_torch.ops.masks import TokenInfo

    dev, card, rnd, kernels = env.dev, env.card, env.rnd, env.kernels
    k2e, k3e = kernels["flash_segment_attention"], kernels["flash_segment_attention_lse"]
    k5q, k5kv = kernels["flash_segment_attention_bwd_dq"], kernels["flash_segment_attention_bwd_dkv"]
    one = batch.map(lambda x: x[0])
    train_info = TokenInfo(one.doc_id, one.fn_id, one.noise_id, one.pos)
    recon_info = G2VLMPipeline(None, cfg).build_recon_prefill(32, 21, 37).token_info(dev)
    shard_counts = {}

    def counted(fn):
        """fn() with its launches added to the shards' path."""
        before = dict(fa.launch_counts)
        out = fn()
        for k_, v_ in fa.launch_counts.items():
            shard_counts[k_] = shard_counts.get(k_, 0) + v_ - before.get(k_, 0)
        return out

    def rel_err(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    for tag, info, with_bwd, iters in (("train_pack_16_views", train_info, True, 5),
                                       ("recon_prefill_32_views", recon_info, False, 3)):
        s_, h, kvh, d = info.seq_len, 12, 2, 128
        q, k, v, dout = rnd(s_, h, d), rnd(s_, kvh, d), rnd(s_, kvh, d), rnd(s_, h, d)
        meta = info.packed()
        codes = fa.block_codes(meta, meta)
        # the reference: the kernels' unsharded launch
        want_out, want_lse = fa._segment_forward_cuda(q, k, v, meta, meta, codes, None, with_lse=with_bwd)
        whole_ms = _time_ms(lambda: fa._segment_forward_cuda(q, k, v, meta, meta, codes, None, with_lse=with_bwd),
                            iters)
        if with_bwd:
            want = fa._segment_backward_cuda(q, k, v, want_out, want_lse, dout, meta, meta, codes, None)
            whole_bwd_ms = _time_ms(lambda: fa._segment_backward_cuda(q, k, v, want_out, want_lse, dout, meta, meta,
                                                                      codes, None), iters)
        for n in (2, 4):
            rows = s_ // n
            if s_ % n or rows % fa.TILE:
                _fail(f"phase 23(b) {tag}: {s_} rows do not cut into {n} shards of whole {fa.TILE}-row tiles")
            outs, lses, dqs, dk, dv, fwd_ms, bwd_ms = [], [], [], 0.0, 0.0, [], []
            for r in range(n):
                # rank r's body in `sp_attender`: the public wrapper on its query rows against the whole K / V,
                # under autograd where the step trains (K3, then K5 from the autograd call)
                sl = slice(r * rows, (r + 1) * rows)
                info_r = TokenInfo(*(f[sl] for f in info))
                plan = fa.segment_plan(info_r, info)
                q_r, k_r, v_r = (t.detach().requires_grad_(with_bwd) for t in (q[sl], k, v))
                dout_r = dout[sl].contiguous()

                def fwd():
                    return segment_attention(q_r, k_r, v_r, info_r, info, plan=plan)

                out_r = counted(fwd)
                fwd_ms.append(_time_ms(fwd, iters))
                outs.append(out_r.detach())
                if with_bwd:
                    lses.append(out_r.grad_fn.saved_tensors[4])  # the lse K3 saved for K5

                    def bwd():
                        return torch.autograd.grad(out_r, (q_r, k_r, v_r), dout_r, retain_graph=True)

                    dq_r, dk_r, dv_r = counted(bwd)
                    bwd_ms.append(_time_ms(bwd, iters))
                    dqs.append(dq_r)
                    dk, dv = dk + dk_r.float(), dv + dv_r.float()
            out = torch.cat(outs)
            bitwise = torch.equal(out, want_out)
            errs = {"out": rel_err(out, want_out)}
            if with_bwd:
                lse = torch.cat(lses, dim=1)
                bitwise = bitwise and torch.equal(lse, want_lse)
                errs["lse"] = rel_err(lse, want_lse)
                grads = {"dq": (torch.cat(dqs), want[0]), "dk": (dk, want[1]), "dv": (dv, want[2])}
                errs.update({g: rel_err(a, b) for g, (a, b) in grads.items()})
            print(f"[sp-shards] {tag} n={n}: {n} shards of {rows} query rows against {s_} keys; "
                  + ("K3" if with_bwd else "K2") + f" out (and lse) bitwise equal to the unsharded launch: {bitwise}; "
                  f"max|err|/max|ref| {', '.join(f'{g} {e:.3e}' for g, e in errs.items())}; forward per shard "
                  f"{[round(t, 3) for t in fwd_ms]} ms against {whole_ms:.3f} unsharded"
                  + (f"; K5 (dq + dkv) per shard {[round(t, 3) for t in bwd_ms]} ms against {whole_bwd_ms:.3f}"
                     if with_bwd else "") + f" ({card})")
            if max(errs[g] for g in errs if g in ("out", "lse")) > 2e-3:
                _fail(f"phase 23(b) {tag} n={n}: the shards' forward is off the unsharded launch: {errs}")
            if with_bwd and max(errs[g] for g in ("dq", "dk", "dv")) > 1e-2:
                _fail(f"phase 23(b) {tag} n={n}: the shards' K5 is off the unsharded launch: {errs}")
            row = dict(shape=f"q({rows},{h},{d}) kv({s_},{kvh},{d})", ms=statistics.mean(fwd_ms),
                       unsharded_ms=whole_ms, bitwise=bitwise, max_rel_err=errs)
            (k3e if with_bwd else k2e).setdefault("at", {})[f"sp{n}_shard_{tag}"] = row
            if with_bwd:
                for e in (k5q, k5kv):
                    e.setdefault("at", {})[f"sp{n}_shard_{tag}"] = dict(
                        shape=row["shape"], dq_dk_dv_ms=statistics.mean(bwd_ms), unsharded_ms=whole_bwd_ms,
                        max_rel_err={g: errs[g] for g in ("dq", "dk", "dv")})
        del q, k, v, dout, want_out, want_lse
        torch.cuda.empty_cache()

    return shard_counts


def _two_rank_worker(rank, port, queue):
    """One rank of 23(c): the cut-depth phase 10 step on a (1, 2, 1) mesh, attention sequence-parallel."""
    import torch
    import torch.distributed as dist

    import train_torch
    from g2vlm_tpu_torch.config import G2VLMConfig, cut_depth_config
    from g2vlm_tpu_torch.parallel.mesh import FSDP, make_mesh, shard_model
    from g2vlm_tpu_torch.train import trainer
    from g2vlm_tpu_torch.weights import build_model

    world = 2 if rank >= 0 else 1  # rank -1: the one-rank run
    torch.cuda.set_device(max(rank, 0))
    dev = torch.device("cuda", max(rank, 0))
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=max(rank, 0), world_size=world)
    try:
        cut = cut_depth_config(G2VLMConfig(visual_und=False), 2)
        mesh = make_mesh(world, dp=1, fsdp=world, tp=1, device_type="cuda")
        model = build_model(cut, device=dev, dtype=torch.float32, seed=0).train()
        shard_model(model, mesh)
        opt = trainer.make_optimizer(model, learning_rate=1e-4, freeze_und=True, mu_dtype=torch.bfloat16,
                                     factored_v=True)
        state = trainer.init_train_state(model, opt, ema=True)
        batch, geo_start = train_torch.full_size_batch(cut, 2, TRAIN_HW, 1792, 1, dev)
        step = trainer.make_train_step(cut, geo_start=geo_start, sp=mesh[FSDP].get_group() if world > 1 else None)
        _, metrics = step(state, batch)
        queue.put((rank, metrics["loss"].item()))
    finally:
        dist.destroy_process_group()


def _two_rank_step():
    """23(c): 2 spawned ranks against one; losses within 1e-3 (the sequence-parallel attention's dK / dV sums
    and the sharded moments round differently)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    losses = {}
    for ranks in ((-1,), (0, 1)):
        queue, port = ctx.Queue(), _free_port()
        procs = [ctx.Process(target=_two_rank_worker, args=(r, port, queue)) for r in ranks]
        for p_ in procs:
            p_.start()
        got = dict(queue.get(timeout=300) for _ in procs)
        for p_ in procs:
            p_.join(timeout=60)
        losses[len(ranks)] = got
    rel = abs(losses[2][0] - losses[1][-1]) / abs(losses[1][-1])
    print(f"[phase 23c] cut-depth step, 2 NCCL ranks (fsdp=2, sequence parallel): loss {losses[2]} against one "
          f"rank's {losses[1][-1]!r}, rel {rel:.3e} (budget 1e-3)")
    if not rel <= 1e-3 or losses[2][0] != losses[2][1]:
        _fail(f"phase 23(c): two ranks' loss {losses[2]} against one rank's {losses[1][-1]}")

# ---------------------------------------------------------------------------
# phase 24: the program's spans
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _span_lines(span, depth=0):
    """The span tree as lines: name, host ms, device ms, counters."""
    dev = span.device_ms
    line = (f"{'  ' * depth}{span.name}: host {span.host_s * 1e3:.3f} ms, device "
            + ("not measured" if dev is None else f"{dev:.3f} ms")
            + (f", {span.counters}" if span.counters else ""))
    return [line] + [x for c in span.children for x in _span_lines(c, depth + 1)]


def _idle_by_span(events, names, min_gap_us=10.0):
    """From a chrome trace of one call (its top-level span among `names`): the window (the top span's
    start to the later of its end and the last device event), the device's busy us in it, and the idle
    us by the innermost span in `names` open over each part of each gap of `min_gap_us` or more (time
    overlap; "(no span)" where none is open), gaps under it summed apart; and the host-to-device copies'
    bytes."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") in names)
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    htod = sum(int(e.get("args", {}).get("bytes", 0)) for e in events
               if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""))
    top = max(spans, key=lambda s_: s_[1] - s_[0])
    w0, w1 = top[0], max([top[1]] + [b for _, b in dev])
    merged = []
    for a, b in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    idle = {}
    for a, b in ((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)):
        if b - a < min_gap_us:
            idle["(gaps under 10 us)"] = idle.get("(gaps under 10 us)", 0.0) + max(b - a, 0.0)
            continue
        inside = [s_ for s_ in spans if s_[0] < b and s_[1] > a]
        cuts = sorted({a, b} | {x for s_ in inside for x in s_[:2] if a < x < b})
        for c0, c1 in zip(cuts, cuts[1:]):
            cover = [s_ for s_ in inside if s_[0] <= c0 and s_[1] >= c1]
            label = min(cover, key=lambda s_: s_[1] - s_[0])[2] if cover else "(no span)"
            idle[label] = idle.get(label, 0.0) + (c1 - c0)
    return (w1 - w0), busy, idle, htod


def _tracing_phase(env):
    """Phase 24: the program's spans on the card at full width (module docstring)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from g2vlm_tpu_torch.config import G2VLMConfig
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
    from g2vlm_tpu_torch.utils import tracing
    from g2vlm_tpu_torch.weights import build_model

    card = env.card
    t_phase = time.perf_counter()
    cfg = G2VLMConfig()
    pipe = G2VLMPipeline(build_model(cfg, device=env.dev, dtype=torch.bfloat16, seed=0), cfg)
    rng = np.random.default_rng(24)
    recon_frames = rng.integers(0, 256, (32, 294, 518, 3), dtype=np.uint8)
    chat_frames = list(rng.integers(0, 256, (4, 480, 640, 3), dtype=np.uint8))

    def recon():
        pipe.recon_from_frames(recon_frames)
        torch.cuda.synchronize()

    def chat(return_info=False):
        pipe.chat(chat_frames, QUESTION, max_new_tokens=32, return_info=return_info)
        torch.cuda.synchronize()

    tracing.clear()  # requests that earlier phases recorded through return_info
    for fn in (recon, recon, chat, chat):
        fn()
    if tracing.span("probe") is not tracing.OFF or tracing.requests():
        _fail("phase 24: the recorder recorded with neither a profiler nor tracing.record()")

    def profiled(tag, fn):
        tracing.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
        [req] = tracing.requests()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        window, busy, idle, htod = _idle_by_span(events, {s_.name for s_ in req.walk()})
        print(f"[tracing] {tag}: span tree (host ms, device ms):\n    " + "\n    ".join(_span_lines(req)))
        print(f"[tracing] {tag}: window {window / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle "
              f"{(window - busy) / 1e3:.3f} ms ({100 * (1 - busy / window):.1f}%); idle by the innermost span "
              "open over it (ms): " + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in sorted(idle.items(), key=lambda kv: -kv[1]))
              + f"; host-to-device copies in the trace {htod} bytes, upload.bytes {req.counters.get('upload.bytes', 0)}")
        return req, busy, idle

    req, busy, idle = profiled("recon, 32 views of 294x518", recon)
    stages = {c.name: c.device_ms for c in req.children}
    if set(stages) != {"input", "dino", "decoder", "heads"} or None in stages.values():
        _fail(f"phase 24: the recon call's stage spans are {stages}")
    # a span's device ms runs from event to event, so it holds the idle while the card waits for the
    # host inside it: held against the busy time plus the idle that the trace puts inside the stages
    spans_ms, idle_in = sum(stages.values()), sum(idle.get(k, 0.0) for k in stages) / 1e3
    share = spans_ms / (busy / 1e3 + idle_in)
    print(f"[tracing] recon: stage spans' device ms {spans_ms:.3f} = {100 * spans_ms / (busy / 1e3):.1f}% of the "
          f"profiler's busy {busy / 1e3:.3f} ms, {share * 100:.1f}% of it plus the {idle_in:.3f} ms of idle inside "
          f"the stage spans (the recon span's own {req.device_ms:.3f} ms)")
    if not 0.9 <= share <= 1.1:
        _fail(f"phase 24: recon's device spans cover {share * 100:.1f}% of the busy time and the idle inside "
              "them, outside 90-110%")
    profiled("chat, 4 views of 480x640, 32 tokens", chat)
    profiled("chat with return_info (stage syncs)", lambda: chat(return_info=True))

    def ms(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    def recorded(fn):
        def run():
            with tracing.record():
                fn()
        return run

    for tag, variants in (("recon", {"off": recon, "on": recorded(recon)}),
                          ("chat", {"off": chat, "on": recorded(chat), "return_info": lambda: chat(True)})):
        times = {k: [] for k in variants}
        for i in range(6):
            for k in (list(variants) if i % 2 == 0 else list(variants)[::-1]):
                times[k].append(ms(variants[k]))
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"[tracing] {tag} in turns x6, median ms: "
              + ", ".join(f"{k} {med[k]:.3f} ({[round(t, 1) for t in times[k]]})" for k in variants)
              + "; on - off " + ", ".join(f"{k} {med[k] - med['off']:+.3f} ms ({100 * (med[k] / med['off'] - 1):+.2f}%)"
                                          for k in variants if k != "off") + f" ({card})")
    tracing.clear()
    print(f"[tracing] phase 24 in {time.perf_counter() - t_phase:.1f} s ({card})")


def _kimivl_phase(env):
    """Phase 25: the "mla_moe" decoder at full width and cut depth, and the MLA forward at the recon
    prefill's size. Returns the kernels' launches of the chat request."""
    import gc

    import numpy as np
    import torch

    from benchmark import weights as bench_weights
    from benchmark.drivers.recon_kimivl import program_config
    from benchmark.reference import kimivl as ref, layout
    from g2vlm_tpu_torch.inference import decoding
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
    from g2vlm_tpu_torch.ops import flash_attention as fa
    from g2vlm_tpu_torch.ops.masks import make_segment_mask
    from g2vlm_tpu_torch.weights import build_model

    dev, card = env.dev, env.card
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark", "configs",
                           "g2vlm-kimivl-a3b-bf16.json")) as f:
        full = json.load(f)
    rc = dict(full, num_hidden_layers=5, dino=dict(full["dino"], num_hidden_layers=2),
              vit=dict(full["vit"], depth=2), pi3=dict(full["pi3"], depth=2))
    cut = program_config(rc)

    # ---- 25a. a chat request against the reference's full forward -----------------------------------
    seed = 1234567
    model = build_model(cut, device=dev, dtype=torch.bfloat16, seed=None)
    bench_weights.load_into(model, ref.param_shapes(rc), seed)
    pipe = G2VLMPipeline(model, cut)
    frames = list(np.random.default_rng(3).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8))
    question = " ".join(["where"] * 8 + ["is", "the", "red", "chair", "relative", "to", "the", "door"] * 2)
    fa.reset_launch_counts()
    _, info = pipe.chat(frames, question, max_new_tokens=8, return_info=True)
    torch.cuda.synchronize()
    launches = _launches(fa)
    served = info["token_ids"]
    if launches.get("flash_mla_attention") != cut.llm.num_hidden_layers:
        _fail(f"kimivl chat: launches {launches}, expected {cut.llm.num_hidden_layers} flash_mla_attention")
    with torch.inference_mode():
        prefill, _, lats, _, _ = pipe.chat_prefill(frames, question)
        cache = decoding.build_cache(lats, prefill.seq_len, cut.llm, prefill.seq_len + 16, torch.bfloat16)
        got = torch.stack([decoding.decode_step(model.language_model, cache, tok, prefill.seq_len + j, cut.llm)[0]
                           for j, tok in enumerate([layout.EOS] + served[:-1])])
    del model, pipe, cache, lats
    gc.collect()
    torch.cuda.empty_cache()
    W = {}
    for part in bench_weights.chunks(ref.param_shapes(rc), seed, dev, torch.bfloat16):
        W.update(part)
    with torch.no_grad():
        want = ref.chat_logits(ref.Fp32(W), rc, frames, question, served, dev)
    del W
    rel = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
    gaps = (want.max(-1).values - want.gather(1, torch.as_tensor(served, device=dev)[:, None])[:, 0]).tolist()
    if not torch.isfinite(got).all() or rel > 3e-2:
        _fail(f"kimivl chat: logits off the reference's by {rel:.3e} (budget 3e-2)")
    if int(got[0].argmax()) != served[0]:
        _fail("kimivl chat: the decode step's first token is not the one chat served")
    print(f"[kimivl-chat] cut depth ({cut.llm.num_hidden_layers} layers: 1 dense + 4 MoE), 2 views of 480x640, "
          f"{len(question.split())} words, {len(served)} greedy tokens, a prompt of {prefill.seq_len} rows: "
          f"logits (prefill, latent cache, absorbed decode, bf16) against the fp32 reference's full forward: "
          f"||d|| / ||ref|| {rel:.3e} (budget 3e-2), max |d| {(got - want).abs().max().item():.3e} of max |ref| "
          f"{want.abs().max().item():.3e}; the reference's gap below its best at each served token "
          f"{[round(g, 4) for g in gaps]}; launches {launches}")
    del got, want
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 25b. the MLA forward at the 32-view recon prefill ------------------------------------------
    pre = G2VLMPipeline(None, cut).build_recon_prefill(32, 21, 37)
    rec_info = pre.token_info(dev)
    s, h = len(pre.doc_id), cut.llm.num_attention_heads
    dqk, dv = fa.MLA_HEAD_DIMS
    q, k, v = env.rnd(s, h, dqk), env.rnd(s, h, dqk), env.rnd(s, h, dv)
    plan = fa.segment_plan(rec_info, rec_info)

    def kernel():
        return fa.flash_mla_attention(q, k, v, rec_info, rec_info, plan=plan)

    def plain():
        return fa.segment_attention_chunked(q.float(), k.float(), v.float(), rec_info, rec_info)

    max_err, mean_err, ms, plain_ms = _compare_timed(kernel, plain, 3)
    if max_err > FWD_MAX_ABS or mean_err > FWD_MEAN_ABS:
        _fail(f"mla forward: max |err| {max_err:.3e}, mean {mean_err:.3e}")
    if not torch.equal(kernel(), kernel()):
        _fail("mla forward: two launches differ")
    ms = statistics.median([_time_ms(kernel, 5) for _ in range(3)])
    pairs = env.visible_pairs(rec_info)
    bound_ms, bound_by = _bound(2.0 * s * h * (2 * dqk + 2 * dv), 2.0 * pairs * h * (dqk + dv))
    mask = make_segment_mask(rec_info, rec_info)
    library_ms, why = _library_ms(lambda: env.sdpa(q, k, v, attn_mask=mask), 2)
    del mask
    e = env.entry_for("flash_mla_attention", "none: the port's own (the JAX package has no MLA layer)")
    e.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
             max_abs_err=max(e["max_abs_err"], max_err))
    if why:
        e["library_note"] = why
    print(f"[mla] flash_mla_attention at the recon prefill: {s} rows, {h}:{h} heads, QK {dqk} / V {dv}, "
          f"{pairs} visible pairs: {ms:.3f} ms (plain fp32 {plain_ms:.1f} ms; library "
          f"{'%.3f ms' % library_ms if library_ms else why}); bound {bound_ms:.3f} ms ({bound_by}), "
          f"{100 * bound_ms / ms:.1f}% of it; max |err| {max_err:.3e}, mean {mean_err:.3e}; two launches "
          f"bitwise equal; phase 25 in {time.perf_counter() - t_phase:.1f} s ({card})")
    del q, k, v, plan
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 25c. chat at full size: 27 layers, the latent cache, the decode loop's CUDA graph ---------
    cfg = program_config(full)
    model = build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    pipe = G2VLMPipeline(model, cfg)
    frames = list(np.random.default_rng(4).integers(0, 256, (4, 480, 640, 3), dtype=np.uint8))
    torch.cuda.reset_peak_memory_stats()
    infos = [pipe.chat(frames, question, max_new_tokens=32, return_info=True)[1] for _ in range(3)]
    ttft = [1e3 * i["t_prefill_s"] for i in infos]
    per_token = [1e3 * i["t_decode_s"] / i["num_tokens"] for i in infos]
    if any(i["num_tokens"] < 1 for i in infos) or len({tuple(i["token_ids"]) for i in infos}) != 1:
        _fail(f"kimivl full-size chat: tokens differ between requests or none came: {[i['token_ids'] for i in infos]}")
    print(f"[kimivl-chat-full] g2vlm-kimivl-a3b-bf16 at full size, 4 views of 480x640, {len(question.split())} words, "
          f"a prompt of {infos[0]['prefill_len']} rows, {infos[0]['num_tokens']} greedy tokens, 3 requests: prefill + "
          f"cache {[round(t, 1) for t in ttft]} ms, decode {[round(t, 2) for t in per_token]} ms a token (the first "
          f"step eager, then the CUDA graph), peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    views = np.random.default_rng(5).integers(0, 256, (32, 294, 518, 3), dtype=np.uint8)
    fa.reset_launch_counts()
    pipe.recon_from_frames(views, new_width=518)
    torch.cuda.synchronize()
    recon_launches = _launches(fa)
    want = {"flash_batched_attention": cfg.dino.num_hidden_layers + cfg.pi3.depth * (2 + 2 * cfg.use_global_points),
            "flash_mla_attention": cfg.llm.num_hidden_layers}
    if recon_launches != want:
        _fail(f"kimivl recon: launches {recon_launches}, expected {want} per call")
    print(f"[kimivl-recon] 32 views of 294x518 at full size: launches per call {recon_launches} ({card})")
    del model, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return launches


if __name__ == "__main__":
    main()

