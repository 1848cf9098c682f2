"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py             # from the repository root; needs one card
    python3 chip_smoke.py --profile   # also prints torch.profiler kernel tables

Phases (each prints its result; any failure raises and the exit code is 1):
  1. device: the card's name and power limit;
  2. build: nvcc builds the attention kernels from g2vlm_tpu_torch/csrc, one
     process per source, in parallel;
  3. K1 (batched attention) against its plain version at the recon shapes;
  4. K2 (segment attention) against its plain (chunked) version at the
     32-view recon prefill, a small mixed case and an extreme-logit case;
  5. recon parity: a full-width, cut-depth model runs recon_from_frames on the
     card in bf16 (kernels) and on the CPU in fp32 (plain versions);
  6. the recon slice: G2VLMConfig(visual_und=False) with random bf16 weights, 32
     uint8 views of 294x518, launch counts, shapes, finiteness and timing;
  7. K3 / K6 (the lse forwards): out bitwise equal to K2 / K1, lse against the
     plain version, at the training shapes;
  8. K5 / K7 (the dq and dkv backward kernels) against the plain backward at
     the training shapes, with exact zeros for rows and keys that see nothing;
  9. train parity: one forward + backward of the cut-depth full-width model on
     the card (fp32 masters, bf16 compute, kernels) against the CPU (fp32,
     plain versions): loss and gradient norms;
 10. the training slice: the recon-stage step of train_torch.py at full width
     and depth (16 views of 294x518 in a 12,800-token pack, SPLIT layout, und
     expert frozen, factored Adam with a bf16 first moment, EMA, per-layer
     checkpointing), a few steps on one repeated batch.
Every kernel is also timed beside the one PyTorch library call that computes
the same function (a yardstick only; the port never calls it). The last line is
{"ok": true, "device": {...}}; before it, the card's line and one JSON line
that lists the kernels with their launches, errors, times and bounds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

# the card's published peaks (H100 SXM): dense bf16 tensor-core rate and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# limits of a bf16 kernel against its plain fp32 version
FWD_MAX_ABS, FWD_MEAN_ABS = 2e-2, 1e-3  # forwards: outputs are O(1)
# backwards, relative to the plain result (max |err| / max |ref|, mean |err| / mean |ref|): P and dS
# are rounded to bf16 before the second products and every output once more (2^-9 = 2e-3 each), so
# the mean cannot reach the 1e-3 of the forwards; seen on the H100: max 5.0e-3, mean 2.2e-3 to 2.8e-3
BWD_MAX_REL, BWD_MEAN_REL = 2e-2, 5e-3
LSE_MAX_ABS = 2e-3
TRAIN_VIEWS, TRAIN_HW, TRAIN_TOKENS = 16, (294, 518), 12800


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


def _rel_errors(got, want):
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    return (err.max() / ref.max()).item(), (err.mean() / ref.mean()).item(), err.max().item()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true", help="profile one recon call and one training step")
    args = ap.parse_args()

    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    import numpy as np
    import torch.nn.functional as F

    import train_torch
    from g2vlm_tpu_torch.config import G2VLMConfig
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
    from g2vlm_tpu_torch.ops import flash_attention as fa
    from g2vlm_tpu_torch.ops.masks import TokenInfo, make_segment_mask, make_token_info
    from g2vlm_tpu_torch.train import trainer
    from g2vlm_tpu_torch.weights import build_model

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

    def entry_for(kname, replaces, source="g2vlm_tpu_torch/csrc/attention.cu"):
        return kernels.setdefault(kname, {
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "launches_recon_call": 0, "launches_train_step": 0, "max_abs_err": 0.0,
        })

    k1e = entry_for("flash_batched_attention", "g2vlm_tpu/ops/flash_attention.py:1058")
    k2e = entry_for("flash_segment_attention", "g2vlm_tpu/ops/flash_attention.py:168")
    k3e = entry_for("flash_segment_attention_lse", "g2vlm_tpu/ops/flash_attention.py:239")
    bwd_src = "g2vlm_tpu_torch/csrc/attention_bwd.cu"
    k5q = entry_for("flash_segment_attention_bwd_dq", "g2vlm_tpu/ops/flash_attention.py:385", bwd_src)
    k5kv = entry_for("flash_segment_attention_bwd_dkv", "g2vlm_tpu/ops/flash_attention.py:435", bwd_src)
    k6e = entry_for("flash_batched_attention_lse", "g2vlm_tpu/ops/flash_attention.py:1127")
    k7q = entry_for("flash_batched_attention_bwd_dq", "g2vlm_tpu/ops/flash_attention.py:1164", bwd_src)
    k7kv = entry_for("flash_batched_attention_bwd_dkv", "g2vlm_tpu/ops/flash_attention.py:1195", bwd_src)

    # ---- 3. K1 -------------------------------------------------------------
    k1_cases = [
        ("dinov2", 32, 782, 782, 16, 64, None, False),
        ("pi3_self", 32, 777, 777, 16, 96, None, False),
        ("pi3_cross_frame0", 32, 777, 777, 16, 96, None, True),
        ("pi3_self_valid_kv", 32, 777, 777, 16, 96, 700, False),
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
        k1e["max_abs_err"] = max(k1e["max_abs_err"], mx)
        if tag == "dinov2":
            lib, why = _library_ms(lambda: sdpa(q, k, v), 20)
            bound_ms, by = _attention_bound(b * s * m, h, d, 2, b * s, b * m, h, 2, 2)
            k1e.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, library_ms=lib,
                       shape=f"({b},{s},{h},{d})")
            print(f"[K1] {tag}: bound {bound_ms:.4f} ms by {by}; library scaled_dot_product_attention "
                  f"{lib} ms {why or ''}")

    # ---- 4. K2 -------------------------------------------------------------
    shape_pipe = G2VLMPipeline(None, G2VLMConfig(visual_und=False))
    pre = shape_pipe.build_recon_prefill(32, 21, 37)
    recon_info = pre.token_info(dev)
    mixed = make_token_info([100, 156], [40, 60, 56, 100], ["causal", "full", "causal", "noise"],
                            pad_to=320, device=dev)

    def live_pairs(info):
        """Query-key pairs in the tiles the kernels do not skip (what this run's data needs)."""
        meta = info.packed()
        return int((fa.block_codes(meta, meta) != fa.BLOCK_SKIP).sum().item()) * fa.TILE * fa.TILE

    def gqa_mask_call(q, k, v, info):
        """The library call for the segment kernels: GQA attention with the
        boolean segment mask materialised beforehand."""
        mask = make_segment_mask(info, info)
        return lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)

    for tag, info, h, kvh, d, iters in (
        ("recon_prefill_32_views", recon_info, 12, 2, 128, 5),
        ("mixed_docs_padded", mixed, 12, 2, 128, 20),
    ):
        n = info.seq_len
        q, k, v = rnd(n, h, d), rnd(n, kvh, d), rnd(n, kvh, d)
        qf, kf, vf = q.float(), k.float(), v.float()
        mx, mean, ms, plain_ms = _compare_timed(
            lambda: fa.flash_segment_attention(q, k, v, info, info),
            lambda: fa.flash_segment_attention_reference(qf, kf, vf, info, info),
            iters=iters,
        )
        print(f"[K2] {tag} q{(n, h, d)} kv{(n, kvh, d)}: max_abs_err {mx:.3e} mean_abs_err {mean:.3e} "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms ({card})")
        if mx > FWD_MAX_ABS or mean > FWD_MEAN_ABS:
            _fail(f"K2 {tag} disagrees with its plain version (max {mx}, mean {mean})")
        k2e["max_abs_err"] = max(k2e["max_abs_err"], mx)
        if tag == "recon_prefill_32_views":
            out = fa.flash_segment_attention(q, k, v, info, info)
            if (out[info.doc_id < 0] != 0).any():
                _fail("K2: padding rows that see no key are not 0")
            del out
            lib, why = _library_ms(gqa_mask_call(q, k, v, info), 3)
            bound_ms, by = _attention_bound(live_pairs(info), h, d, 2, n, n, kvh, 2, 2)
            k2e.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, library_ms=lib,
                       shape=f"({n},{h}:{kvh},{d})")
            print(f"[K2] {tag}: bound {bound_ms:.3f} ms by {by}; library scaled_dot_product_attention "
                  f"(enable_gqa, materialised mask) {lib} ms {why or ''}")
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
    cut = dataclasses.replace(
        full_cfg,
        llm=dataclasses.replace(full_cfg.llm, num_hidden_layers=2, vocab_size=5120),
        dino=dataclasses.replace(full_cfg.dino, num_hidden_layers=2),
        pi3=dataclasses.replace(full_cfg.pi3, depth=2),
    )
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
    launches = {k: v for k, v in fa.launch_counts.items() if v}
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
    recon_launches = {k: v for k, v in fa.launch_counts.items() if v}
    if recon_launches != {"flash_batched_attention": want_k1, "flash_segment_attention": want_k2}:
        _fail(f"recon slice: launches {recon_launches}, expected K1 {want_k1} and K2 {want_k2} per call")
    shapes = {"points": (32, 294, 518, 3), "local_points": (32, 294, 518, 3),
              "global_points": (32, 294, 518, 3), "camera_poses": (32, 4, 4)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
            _fail(f"recon slice: {key} has shape {tuple(out[key].shape)} or non-finite values")
    rot = out["camera_poses"][:, :3, :3]
    orth = (rot @ rot.transpose(1, 2) - torch.eye(3, device=dev)).abs().max().item()
    if orth > 1e-3:
        _fail(f"recon slice: camera rotations are not orthonormal ({orth})")
    print(f"[slice] launches per call {recon_launches}; outputs finite, shapes {shapes}; "
          f"rotation orthonormality err {orth:.2e}")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipe.recon_from_frames(frames)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
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

    for tag, info, h, kvh, d, iters in (
        ("train_pack_16_views", train_info, 12, 2, 128, 5),
        ("mixed_docs_padded", mixed, 12, 2, 128, 20),
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
        ms3, plain3 = _timed_in_turns(
            lambda: fa._segment_forward_cuda(q, k, v, meta, meta, codes, None, with_lse=True),
            lambda: fa.flash_segment_attention_lse_reference(q.float(), k.float(), v.float(), info, info), iters)
        print(f"[K3] {tag} q{(n, h, d)} kv{(n, kvh, d)}: out == K2 bitwise, lse max_abs_err {lse_err:.3e}, "
              f"kernel {ms3:.3f} ms plain {plain3:.3f} ms ({card})")
        k3e["max_abs_err"] = max(k3e["max_abs_err"], lse_err)
        # K5: dq, dk, dv against the plain backward on the kernel's own out and lse
        got = fa._segment_backward_cuda(q, k, v, out, lse, dout, meta, meta, codes, None)
        want = fa.flash_segment_attention_bwd_reference(q.float(), k.float(), v.float(), out.float(), lse,
                                                        dout.float(), info, info)
        worst = check_grads(f"K5 {tag}", got, want, pad if pad.any() else None)
        k5q["max_abs_err"] = max(k5q["max_abs_err"], worst)
        k5kv["max_abs_err"] = max(k5kv["max_abs_err"], worst)
        del got, want, plain_lse
        if tag == "train_pack_16_views":
            def run(which):
                return fa._segment_backward_cuda(q, k, v, out, lse, dout, meta, meta, codes, None, which=which)

            def plain_bwd():
                return fa.flash_segment_attention_bwd_reference(
                    q.float(), k.float(), v.float(), out.float(), lse, dout.float(), info, info)

            ms_dq, plain5 = _timed_in_turns(lambda: run(("dq",)), plain_bwd, 3)
            ms_dkv = _time_ms(lambda: run(("dkv",)), iters)
            pairs = live_pairs(info)
            b3, by3 = _attention_bound(pairs, h, d, 2, n, n, kvh, 2, 2, stat_rows=n * h)
            bq, byq = _attention_bound(pairs, h, d, 3, n, n, kvh, 3, 2, stat_rows=2 * n * h)
            bkv, bykv = _attention_bound(pairs, h, d, 4, n, n, kvh, 2, 4, stat_rows=2 * n * h)
            lib_fwd, why = _library_ms(gqa_mask_call(q, k, v, info), 3)
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
            k3e.update(ms=ms3, plain_ms=plain3, bound_ms=b3, bound_by=by3, library_ms=lib_fwd, shape=shape)
            k5q.update(ms=ms_dq, plain_ms=plain5, bound_ms=bq, bound_by=byq, library_ms=lib_bwd, shape=shape,
                       plain_and_library_cover="dq+dk+dv")
            k5kv.update(ms=ms_dkv, plain_ms=plain5, bound_ms=bkv, bound_by=bykv, library_ms=lib_bwd, shape=shape,
                        plain_and_library_cover="dq+dk+dv")
            print(f"[K5] {tag}: dq kernel {ms_dq:.3f} ms (bound {bq:.3f} by {byq}), dkv kernel {ms_dkv:.3f} ms "
                  f"(bound {bkv:.3f} by {bykv}), plain backward (dq+dk+dv) {plain5:.3f} ms; K3 bound {b3:.3f} ms; "
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
        ms6, plain6 = _timed_in_turns(
            lambda: fa._batched_forward_cuda(q, k, v, valid, None, with_lse=True),
            lambda: fa.flash_batched_attention_lse_reference(q.float(), k.float(), v.float(), valid), 20)
        print(f"[K6] {tag} q{(b, s, h, d)} kv{(kb, m, h, d)} valid_kv={valid}: out == K1 bitwise, lse max_abs_err "
              f"{lse_err:.3e}, kernel {ms6:.3f} ms plain {plain6:.3f} ms ({card})")
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
            pairs = b * s * m
            b6, by6 = _attention_bound(pairs, h, d, 2, b * s, b * m, h, 2, 2, stat_rows=b * s * h)
            bq, byq = _attention_bound(pairs, h, d, 3, b * s, b * m, h, 3, 2, stat_rows=2 * b * s * h)
            bkv, bykv = _attention_bound(pairs, h, d, 4, b * s, b * m, h, 2, 4, stat_rows=2 * b * s * h)
            lib_fwd, why = _library_ms(lambda: sdpa(q, k, v), 20)
            ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
            lib_out = sdpa(ql, kl, vl)
            lib_dout = dout.transpose(1, 2)
            lib_bwd, why_bwd = _library_ms(
                lambda: torch.autograd.grad(lib_out, (ql, kl, vl), lib_dout, retain_graph=True), 20)
            shape = f"({b},{s},{h},{d})"
            k6e.update(ms=ms6, plain_ms=plain6, bound_ms=b6, bound_by=by6, library_ms=lib_fwd, shape=shape)
            k7q.update(ms=ms_dq, plain_ms=plain7, bound_ms=bq, bound_by=byq, library_ms=lib_bwd, shape=shape,
                       plain_and_library_cover="dq+dk+dv")
            k7kv.update(ms=ms_dkv, plain_ms=plain7, bound_ms=bkv, bound_by=bykv, library_ms=lib_bwd, shape=shape,
                        plain_and_library_cover="dq+dk+dv")
            print(f"[K7] {tag}: dq kernel {ms_dq:.3f} ms (bound {bq:.4f} by {byq}), dkv kernel {ms_dkv:.3f} ms "
                  f"(bound {bkv:.4f} by {bykv}), plain backward (dq+dk+dv) {plain7:.3f} ms; K6 bound {b6:.4f} ms; "
                  f"library forward {lib_fwd} ms {why or ''}, library backward (dq+dk+dv) {lib_bwd} ms "
                  f"{why_bwd or ''} ({card})")
            del lib_out, ql, kl, vl
        elif tag == "pi3_self":
            print(f"[K7] {tag}: dq kernel {_time_ms(lambda: run(('dq',)), 20):.3f} ms, dkv kernel "
                  f"{_time_ms(lambda: run(('dkv',)), 20):.3f} ms ({card})")
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

    def step_launches(c, chunks=1):
        """Launches of one training step, derived from the config: every layer's lse forward
        runs twice (the forward, and its recomputation under per-layer checkpointing), each
        backward kernel once; the Pi3 decoders run once per view chunk."""
        pi3 = c.pi3.depth * (2 + 2 * c.use_global_points) * chunks
        batched, segment = c.dino.num_hidden_layers + pi3, c.llm.num_hidden_layers
        return {"flash_segment_attention_lse": 2 * segment, "flash_segment_attention_bwd_dq": segment,
                "flash_segment_attention_bwd_dkv": segment, "flash_batched_attention_lse": 2 * batched,
                "flash_batched_attention_bwd_dq": batched, "flash_batched_attention_bwd_dkv": batched}

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
    fa.reset_launch_counts()
    got_loss, _ = trainer.train_forward(gpu_model, cut_batch.map(lambda x: x[0].to(dev)), cut,
                                        compute_dtype=torch.bfloat16, geo_start=cut_geo_start)
    got_loss.backward()
    torch.cuda.synchronize()
    launches = {k: v for k, v in fa.launch_counts.items() if v}
    if launches != step_launches(cut):
        _fail(f"train parity: launches {launches}, expected {step_launches(cut)}")
    rel = abs(got_loss.item() - want_loss.item()) / abs(want_loss.item())
    print(f"[train-parity] loss card {got_loss.item():.5f} cpu {want_loss.item():.5f} rel {rel:.3e} (budget 3e-2); "
          f"cpu fp32 forward+backward {cpu_s:.1f} s; launches {launches}")
    if not rel <= 3e-2:
        _fail(f"train parity: loss off by {rel} (budget 3e-2)")
    got_norms = grad_norms(gpu_model)
    for g, w in want_norms.items():
        r = abs(got_norms[g] - w) / w
        print(f"[train-parity] grad norm {g}: card {got_norms[g]:.4e} cpu {w:.4e} rel {r:.3e} (budget 1e-1)")
        if not r <= 1e-1:
            _fail(f"train parity: grad norm of {g} off by {r} (budget 1e-1)")
    del cpu_model, gpu_model, got_loss, want_loss
    torch.cuda.empty_cache()

    # ---- 10. the training slice -------------------------------------------------
    n_steps = 4
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
    named = dict(model.named_parameters())
    frozen_names = [n_ for n_, p in named.items() if not p.requires_grad]
    probe = frozen_names[:: max(1, len(frozen_names) // 8)]  # a sample of the frozen leaves, copied
    before = {n_: named[n_].detach().clone() for n_ in probe}
    moved_probe = {n_: p.detach().clone() for n_, p in named.items() if p.requires_grad and p.numel() < 5_000_000}
    want_launches = step_launches(cfg)
    losses, norms, times = [], [], []
    for step in range(n_steps):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, train_batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches = {k: v for k, v in fa.launch_counts.items() if v}
        if launches != want_launches:
            _fail(f"train slice step {step}: launches {launches}, expected {want_launches}")
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        print(f"[train] step {step}: loss {losses[-1]:.5f} grad_norm {norms[-1]:.4f} "
              + " ".join(f"{k} {val.item():.4f}" for k, val in metrics.items() if k not in ("loss", "grad_norm"))
              + f" | {times[-1]:.1f} ms")
        if not (np.isfinite(losses[-1]) and np.isfinite(norms[-1])):
            _fail(f"train slice step {step}: loss or grad norm is not finite")
    if not losses[2] < losses[0]:
        _fail(f"train slice: the loss did not fall over three steps on one batch: {losses}")
    for n_ in probe:
        if not torch.equal(named[n_], before[n_]) or not torch.equal(state.ema_params[n_], before[n_]):
            _fail(f"train slice: frozen parameter {n_} or its EMA changed")
    n_moved = sum(not torch.equal(named[n_], old) for n_, old in moved_probe.items())
    n_ema_moved = sum(not torch.equal(state.ema_params[n_], old) for n_, old in moved_probe.items())
    if n_moved < 0.9 * len(moved_probe) or n_ema_moved < 0.9 * len(moved_probe):
        _fail(f"train slice: only {n_moved} parameters and {n_ema_moved} EMA leaves of {len(moved_probe)} changed")
    ms = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] {TRAIN_VIEWS} views {TRAIN_HW[0]}x{TRAIN_HW[1]}, {TRAIN_TOKENS}-row pack, bf16 compute, fp32 "
          f"masters: {ms:.1f} ms per step (median of steps 1.. of {[round(t, 1) for t in times]}), "
          f"{real_tokens / ms * 1e3:.1f} real tokens/s, peak allocated {peak:.2f} GiB; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; {len(probe)} sampled frozen leaves and their EMA bitwise unchanged, "
          f"{n_moved}/{len(moved_probe)} sampled trainable leaves changed; launches per step {want_launches} ({card})")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step_fn(state, train_batch)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))

    for kname, e in kernels.items():
        e["launches_recon_call"] = recon_launches.get(kname, 0)
        e["launches_train_step"] = launches.get(kname, 0)  # read after the last training step
        e["launches"] = e["launches_recon_call"] + e["launches_train_step"]
        if e["launches"] == 0:
            _fail(f"kernel {kname} was launched on neither main path")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
