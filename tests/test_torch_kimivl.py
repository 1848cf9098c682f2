"""The "mla_moe" decoder (Kimi-VL-A3B's language model as G2VLM's decoder) held to the plain
reference benchmark/reference/kimivl.py at a tiny size on the CPU in float32, where routing
agrees exactly: the layers, recon, chat's prefill and absorbed decode against the full forward,
the router's rule, the published per-expert keys; and the benchmark cell recon-32v-kimivl run
through its harness. The MLA forward kernel against its plain version runs on the card only."""

import ast
import dataclasses
import json
import os
import re
import time

import numpy as np
import pytest
import torch

from benchmark import core, weights
from benchmark.drivers import recon_kimivl
from benchmark.reference import kimivl as ref, layout
from g2vlm_tpu_torch.config import tiny_mla_moe_config
from g2vlm_tpu_torch.inference import decoding
from g2vlm_tpu_torch.models import mla_moe_decoder
from g2vlm_tpu_torch.ops import moe
from g2vlm_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)
CELL = "recon-32v-kimivl"
FULL = core.load_json(os.path.join(core.BENCH, "configs", "g2vlm-kimivl-a3b-bf16.json"))


def tiny_config(dtype: str = "float32") -> dict:
    """The tiny config in the file's layout: the text config's keys at the top level."""
    c = tiny_mla_moe_config()
    d = json.loads(json.dumps(dataclasses.asdict(c)))
    d.update(d.pop("llm"))
    d.pop("dinov3")
    return dict(d, dtype=dtype)


@pytest.fixture(scope="module")
def system():
    cfg = tiny_config()
    pipe = recon_kimivl.build(cfg, 7, "cpu", {})
    return cfg, pipe, weights.reference_weights(ref.param_shapes(cfg), 7, "cpu", torch.float32)


def rel(a, b):
    return (torch.linalg.vector_norm(a.float() - b.float()) / torch.linalg.vector_norm(b.float())).item()


def test_reference_imports_nothing_of_the_system():
    tree = ast.parse(open(ref.__file__).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert not names & {"jax", "jaxlib", "flax", "optax", "g2vlm_tpu", "g2vlm_tpu_torch"}, names


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_published_per_expert_keys_are_the_systems_state_dict(size):
    from g2vlm_tpu_torch.models.g2vlm import G2VLM

    cfg = tiny_config() if size == "tiny" else FULL
    with torch.device("meta"):
        m = G2VLM(recon_kimivl.program_config(cfg))
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert got == ref.param_shapes(cfg)
    assert "language_model.model.layers.1.mlp.experts.0.gate_proj.weight" in got
    if size == "full":
        assert sum(np.prod(v) for v in got.values()) == 17_782_375_716


def test_experts_load_into_their_stacked_slices(system):
    cfg, pipe, W = system
    ex = pipe.model.language_model.model.layers[1].mlp.experts
    p = "language_model.model.layers.1.mlp.experts."
    i = cfg["moe_intermediate_size"]
    for j in (0, cfg["n_routed_experts"] - 1):
        assert torch.equal(ex.gate_up[j, :i], W[f"{p}{j}.gate_proj.weight"])
        assert torch.equal(ex.gate_up[j, i:], W[f"{p}{j}.up_proj.weight"])
        assert torch.equal(ex.down[j], W[f"{p}{j}.down_proj.weight"])
    res = pipe.model.load_state_dict({p + "0.up_proj.weight": W[p + "0.up_proj.weight"]}, strict=False)
    assert not res.unexpected_keys and p + "1.up_proj.weight" in res.missing_keys


def test_router_chooses_with_the_bias_and_weighs_without_it():
    torch.manual_seed(0)
    h = torch.randn(5, 16)
    w = torch.randn(8, 16)
    bias = torch.zeros(8)
    bias[7] = 10.0  # expert 7 is chosen by every token, whatever its score
    idx, gw = moe.route(h, w, bias, 3, 2.446)
    scores = torch.sigmoid(h @ w.t())
    assert (idx == 7).any(-1).all()
    want = scores.gather(1, idx)
    want = want / (want.sum(-1, keepdim=True) + 1e-20) * 2.446
    assert torch.allclose(gw, want) and torch.allclose(gw.sum(-1), torch.full((5,), 2.446))
    r = ref.model.Ref(ref.Fp32({"x.mlp.gate.weight": w, "x.mlp.gate.e_score_correction_bias": bias}),
                      {"num_experts_per_tok": 3, "norm_topk_prob": True, "routed_scaling_factor": 2.446})
    ridx, rw = ref.route(r, h, "x.")
    o, ro = idx.sort(-1), ridx.sort(-1)
    assert torch.equal(o.values, ro.values) and torch.allclose(gw.gather(1, o.indices), rw.gather(1, ro.indices))


def test_the_reference_follows_the_system_only_at_near_ties(monkeypatch):
    torch.manual_seed(1)
    h, w = torch.randn(6, 16), torch.randn(8, 16)
    r = ref.model.Ref(ref.Fp32({"x.mlp.gate.weight": w, "x.mlp.gate.e_score_correction_bias": torch.zeros(8)}),
                      {"num_experts_per_tok": 3, "norm_topk_prob": True, "routed_scaling_factor": 2.446})
    biased, order = torch.sigmoid(h @ w.t()).sort(-1, descending=True)
    swapped = torch.cat([order[:, :2], order[:, 3:4]], -1)  # the 4th expert in place of the 3rd
    gap = biased[:, 2] - biased[:, 3]
    tie = gap.median().item()
    monkeypatch.setattr(ref, "TIE", tie)
    idx, _ = ref.route(r, h, "x.", follow=torch.cat([swapped, swapped[:1]]))  # a padding row after
    followed = (idx.sort(-1).values == swapped.sort(-1).values).all(-1)
    assert torch.equal(followed, gap <= tie) and 0 < followed.sum() < len(h)
    assert torch.equal(idx[~followed].sort(-1).values, order[~followed, :3].sort(-1).values)


def test_balancing_evens_the_load_on_its_scene_and_hands_back_the_biases():
    cfg = tiny_config()
    pipe = recon_kimivl.build(cfg, 5, "cpu", {})
    frames = np.random.default_rng(2).integers(0, 256, (4, 28, 112, 3), dtype=np.uint8)
    rows = layout.recon_layout(4, 2, 8).seq_len  # the system pads the sequence after them
    chosen, route = [], moe.route

    def spy(*a, **kw):
        chosen.append(route(*a, **kw)[0])
        return chosen[-1]

    def load():
        chosen.clear()
        moe.route = lambda *a, **kw: (spy(*a, **kw), route(*a, **kw)[1])
        try:
            pipe.recon_from_frames(frames, new_width=112)
        finally:
            moe.route = route
        n = [torch.bincount(i[:rows].reshape(-1), minlength=cfg["n_routed_experts"]).float() for i in chosen]
        return max((c.max() / c.mean()).item() for c in n)

    before = load()
    bias = recon_kimivl.balance(pipe, cfg, frames, 112, rows)
    after = load()
    state = pipe.model.state_dict()
    assert set(bias) == {k for k in ref.param_shapes(cfg) if k.endswith("e_score_correction_bias")}
    assert all(torch.equal(state[k], v) and abs(v.mean().item()) < 1e-2 for k, v in bias.items())
    assert after < before and after < 1.25, (before, after)


def test_a_count_on_the_device_is_read_when_summarised():
    from g2vlm_tpu_torch.utils import tracing

    tracing.clear()
    with tracing.record(), tracing.span("recon"):
        tracing.count("moe.tokens.l1.max", torch.tensor(30))
        tracing.count("moe.tokens.l1.max", torch.tensor(12))
        tracing.count("moe.tokens.l1.mean", 21.0)
        tracing.count("moe.tokens.l2.max", torch.tensor(21))
        tracing.count("moe.tokens.l2.mean", 21.0)
    assert tracing.summary()["counters"][("recon", "moe.tokens.l1.max")] == 42.0
    assert core.load_module("layer_metrics", "kimivl.moe_load_max_over_mean").read(None) == 1.5
    tracing.clear()


def test_decoder_layers_match_the_reference(system):
    cfg, pipe, W = system
    lm = pipe.model.language_model.model
    lay = layout.recon_layout(2, 3, 4)
    x = torch.randn(lay.seq_len, cfg["hidden_size"], generator=torch.Generator().manual_seed(1))
    from g2vlm_tpu_torch.ops.masks import TokenInfo

    info = TokenInfo.from_numpy(*lay.info)
    with torch.no_grad():
        got = mla_moe_decoder.decoder_forward(lm, x, info)
    want = ref.decoder(ref._ref(W, cfg, None), x, lay)
    assert rel(got, want) < 1e-5


def test_recon_matches_the_reference(system):
    cfg, pipe, W = system
    frames = np.random.default_rng(0).integers(0, 256, (3, 30, 60, 3), dtype=np.uint8)
    got = pipe.recon_from_frames(frames, new_width=56)
    want = ref.recon(W, cfg, torch.as_tensor(frames), 56)
    for k, v in want.items():
        assert rel(got[k], v) < 1e-4, k


def test_chat_prefill_and_latent_decode_match_the_full_forward(system):
    cfg, pipe, W = system
    frames = list(np.random.default_rng(1).integers(0, 256, (1, 40, 52, 3), dtype=np.uint8))
    question = "how far is the chair from the door"
    prefill, _, lats, _, _ = pipe.chat_prefill(frames, question)
    served = [311, 4017, 99, 151645]
    cap = max(prefill.seq_len + 16, len(prefill.doc_id))
    cache = decoding.build_cache(lats, prefill.seq_len, pipe.cfg.llm, cap, dtype=torch.float32)
    assert cache.kv.shape == (cfg["num_hidden_layers"], cap, cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"])
    rows = []
    for j, tok in enumerate([layout.EOS] + served[:-1]):
        logits, cache = decoding.decode_step(pipe.model.language_model, cache, tok, prefill.seq_len + j,
                                             pipe.cfg.llm, compute_dtype=torch.float32)
        rows.append(logits)
    want = ref.chat_logits(W, cfg, frames, question, served, "cpu")
    assert torch.allclose(torch.stack(rows), want, atol=2e-4, rtol=1e-4), (torch.stack(rows) - want).abs().max()
    text, info = pipe.chat(frames, question, max_new_tokens=4, return_info=True)
    assert info["token_ids"][0] == int(want[0].argmax())


def test_paths_it_does_not_serve_raise_with_its_name(system):
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
    from g2vlm_tpu_torch.parallel.mesh import shard_model

    cfg, pipe, _ = system
    for kw in (dict(attn_impl="int8"), dict(attn_pipe=True)):
        with pytest.raises(NotImplementedError, match="mla_moe"):
            G2VLMPipeline(pipe.model, pipe.cfg, **kw)
    frames = list(np.random.default_rng(2).integers(0, 256, (1, 28, 28, 3), dtype=np.uint8))
    with pytest.raises(NotImplementedError, match="mla_moe"):
        pipe.chat(frames, "what", max_new_tokens=2, quantized_kv=True)
    with pytest.raises(NotImplementedError, match="mla_moe"):
        pipe.model.language_model.forward_train(None, None, None, None)
    with pytest.raises(NotImplementedError, match="mla_moe"):
        shard_model(pipe.model, None)
    cache = decoding.LatentCache(torch.zeros(1, 3, 8, 40), torch.zeros(1, dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="mla_moe"):
        decoding.generate_batched(pipe.model.language_model, cache, [1], [0], 2, pipe.cfg.llm)
    with pytest.raises(NotImplementedError, match="mla_moe"):
        decoding.generate_tp(pipe.model.language_model, cache, 1, 0, 2, pipe.cfg.llm, None)


def test_the_kernel_names_of_k2_and_the_mla_forward_are_apart():
    k2 = re.compile(core.load_module("layer_metrics", "k2_roofline.recon").K2)
    mla = re.compile(core.load_module("layer_metrics", "mla_roofline.kimivl").MLA)
    k2_names = [f"void (anonymous namespace)::segment_fwd_kernel<{t}, {d}, false, false, false>"
                f"((anonymous namespace)::SegmentArgs)" for t in ("__nv_bfloat16", "__half") for d in (64, 80, 96, 128)]
    others = [n.replace("false, false, false", flags) for n in k2_names for flags in
              ("true, false, false", "false, true, false", "false, false, true")]
    mla_names = [f"void (anonymous namespace)::mla_fwd_kernel<{t}, 192, 128>((anonymous namespace)::SegmentArgs)"
                 for t in ("__nv_bfloat16", "__half")]
    assert all(k2.search(n) and not mla.search(n) for n in k2_names)
    assert not any(k2.search(n) or mla.search(n) for n in others)
    assert all(mla.search(n) and not k2.search(n) for n in mla_names)
    assert "mla_fwd_kernel<T, 192, 128>" in open(os.path.join(core.ROOT, "g2vlm_tpu_torch", "csrc",
                                                                "attention_segment.cu")).read()


def test_the_cell_runs_through_the_harness_on_the_cpu():
    mix = {"views": 2, "height": 28, "width": 56, "new_width": 56, "scenes": 2, "check_calls": 1, "warmup": 1}
    out = core.run_cell(CELL, 3, 0.5, False, time.perf_counter(), device="cpu",
                        overrides={"config": tiny_config(), "mix": mix})
    assert out["correct"] and out["attempted"] >= 1
    assert {"recon_frames_per_s", "setup_s"} <= set(out["metrics"])
    assert all(c["value"] < 1e-4 for c in out["checks"].values()), out["checks"]


@pytest.mark.cuda
def test_mla_kernel_matches_its_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from g2vlm_tpu_torch.models.g2vlm import SequenceBuilder

    b = SequenceBuilder(151652, 151653)
    b.add_text(list(range(100, 107)))
    b.add_dino_images(3, 21, 37)
    b.add_text(list(range(200, 230)))
    pre = b.build(pad_to=-(-b.curr // 256) * 256)
    info = pre.token_info("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    s = len(pre.doc_id)
    q, k = (torch.randn(s, 16, 192, generator=gen, device="cuda").bfloat16() for _ in range(2))
    v = torch.randn(s, 16, 128, generator=gen, device="cuda").bfloat16()
    got = fa.flash_mla_attention(q, k, v, info, info)
    want = fa.segment_attention_chunked(q.float(), k.float(), v.float(), info, info)
    err = (got.float() - want).abs()
    assert got.shape == (s, 16, 128) and err.max().item() < 2e-2 and err.mean().item() < 1e-3
    assert torch.equal(got, fa.flash_mla_attention(q, k, v, info, info))


@pytest.mark.cuda
def test_grouped_expert_products_match_the_per_expert_loop():
    """The card's `torch._grouped_mm` dispatch against the CPU's product per expert, on the same
    bf16 operands, with some experts given no token."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    g = torch.Generator().manual_seed(0)
    t, d, i, e, k = 1000, 256, 128, 16, 6
    h = torch.randn(t, d, generator=g).bfloat16()
    # each token's k distinct experts among the first e - 4: the last four see no token
    idx = torch.stack([torch.randperm(e - 4, generator=g)[:k] for _ in range(t)])
    w = torch.rand(t, k, generator=g)
    gate_up = (torch.randn(e, 2 * i, d, generator=g) * d ** -0.5).bfloat16()
    down = (torch.randn(e, d, i, generator=g) * i ** -0.5).bfloat16()
    want = moe.moe_experts(h.float(), idx, w, gate_up.float(), down.float())
    got = moe.moe_experts(h.cuda(), idx.cuda(), w.cuda(), gate_up.cuda(), down.cuda()).float().cpu()
    assert rel(got, want) < 1e-2
