"""The fused decode kernels (g2vlm_tpu_torch/csrc/decode_fused.cu: `decode_attention`,
`add_rms_norm`) against their plain versions and against inference/decoding.py's chain on the
card in bf16, at chat-short's shapes (12:2 heads of 128, hidden 1536, caches of ~1,400 and ~7,100
rows in a capacity of 7,296); and the MoT decode step, captured in a CUDA graph, on the kernels
against the chain.

Needs an NVIDIA GPU with nvcc; imports no jax. Run it on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_decode.py -q
"""

import pytest
import torch

from g2vlm_tpu_torch.config import G2VLMConfig, cut_depth_config
from g2vlm_tpu_torch.inference import decoding
from g2vlm_tpu_torch.ops import decode_fused as df
from g2vlm_tpu_torch.ops import flash_attention as fa
from g2vlm_tpu_torch.ops.norms import rms_norm
from g2vlm_tpu_torch.ops.rope import apply_mrope
from g2vlm_tpu_torch.weights import build_model

pytestmark = pytest.mark.cuda

KVH, G, D, HIDDEN, EPS = 2, 6, 128, 1536, 1e-6
CAP = 7296
# elements of a stored row or an output that may lie one bf16 step from the plain version's: the
# fp32 sums run in other orders, and a value on a rounding boundary may round either way
MAX_SHARE_ONE_STEP = 1e-2
# logits of the cut-depth step on the kernels against the chain's, over max |chain|: bf16 activations
# through 4 layers, where a rounding that flips by one step in a norm or a row propagates
LOGIT_REL = 3e-2


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.load_library()
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def _steps_apart(a, b):
    """bf16 steps between a and b, element by element."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


def _inputs(gen, b, cap, g=G, qk_norm=True):
    ang = torch.rand(b, D, generator=gen, device="cuda") * 300
    norms = (_rnd(gen, D, scale=0.3) + 1, _rnd(gen, D, scale=0.3) + 1) if qk_norm else (None, None)
    return dict(q=_rnd(gen, b, KVH * g, D, scale=2), k=_rnd(gen, b, KVH, D, scale=2), v=_rnd(gen, b, KVH, D),
                cos=torch.cos(ang), sin=torch.sin(ang), k_cache=_rnd(gen, b, KVH, cap, D, scale=2),
                v_cache=_rnd(gen, b, KVH, cap, D), q_norm=norms[0], k_norm=norms[1])


def _call(fn, x, length, **kw):
    """fn on copies of the caches: (out, k_cache, v_cache)."""
    kc, vc = x["k_cache"].clone(), x["v_cache"].clone()
    out = fn(x["q"], x["k"], x["v"], x["cos"], x["sin"], kc, vc, length, x["q_norm"], x["k_norm"], EPS, **kw)
    torch.cuda.synchronize()
    return out, kc, vc


def _chain(q, k, v, cos, sin, kc, vc, length, q_norm, k_norm, eps):
    """decoding.py's chain for one layer on the card: q/k norm, apply_mrope, _attend, the store."""
    b, nh, d = q.shape
    cap = kc.shape[2]
    if q_norm is not None:
        q, k = rms_norm(q.float(), q_norm, eps), rms_norm(k.float(), k_norm, eps)
    q, k = apply_mrope(q, k, cos, sin)
    visible = torch.arange(cap, device=q.device)[None, :] < length[:, None]
    out = decoding._attend(q.float().view(b, KVH, nh // KVH, d), kc, vc, None, None, visible, d, k.float(), v.float())
    bi = torch.arange(b, device=q.device)
    pos = length.clamp(0, cap - 1)
    kc[bi, :, pos] = k.float().to(kc.dtype)
    vc[bi, :, pos] = v.float().to(vc.dtype)
    return out.reshape(b, nh * d).to(v.dtype)


def _assert_near(got, want, tag):
    apart = _steps_apart(got, want)
    share = (apart > 0).float().mean().item()
    assert apart.max().item() <= 1 and share <= MAX_SHARE_ONE_STEP, (tag, apart.max().item(), share)


@pytest.mark.parametrize("lengths,cap,g,qk_norm", [
    ([1400], CAP, G, True),  # one view of 480x640
    ([7100], CAP, G, True),  # four views
    ([1400, 7100], CAP, G, True),  # B = 2, the grid's batch axis
    ([7100], CAP, G, False),
    ([0], 256, G, True),  # no cached row: the self term alone
    ([1], 300, G, True),
    ([300, 129], 300, G, True),  # a full cache (the row lands on the last visible one), a split and one row
    ([20000, 48000], 48896, G, True),  # several chunks a split: the two-stage ring
], ids=["1400", "7100", "b2", "7100-nonorm", "len0", "len1", "full-b2", "48k-b2"])
def test_decode_attention_matches_plain_and_the_chain(gen, lengths, cap, g, qk_norm):
    b = len(lengths)
    x = _inputs(gen, b, cap, g, qk_norm)
    length = torch.tensor(lengths, dtype=torch.int64, device="cuda")
    per_split, _ = df.decode_split(cap, KVH, b, torch.cuda.get_device_properties(0).multi_processor_count)
    before = df.launch_counts["decode_attention"]
    got, kc, vc = _call(df.decode_attention, x, length)
    assert df.launch_counts["decode_attention"] == before + 1
    want, kc_p, vc_p = _call(df.decode_attention_plain, x, length, chunks_per_split=per_split)
    chain, kc_c, vc_c = _call(_chain, x, length)
    assert got.shape == (b, KVH * g * D) and got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    for tag, w, kw, vw in (("plain", want, kc_p, vc_p), ("chain", chain, kc_c, vc_c)):
        _assert_near(got, w, f"out against the {tag}")
        _assert_near(kc, kw, f"k cache against the {tag}")
        assert torch.equal(vc, vw), f"v cache against the {tag}"


def test_decode_attention_on_one_scratch_repeats_and_leaves_the_tickets_at_zero(gen):
    """Two launches on one scratch give one output: the last block of each (sequence, KV head)
    resets its ticket, so the next launch (the next layer, the next replay) starts clean."""
    x = _inputs(gen, 2, CAP)
    length = torch.tensor([1400, 7100], dtype=torch.int64, device="cuda")
    scratch = df.decode_scratch(2, KVH, G, CAP, "cuda")
    kc, vc = x["k_cache"].clone(), x["v_cache"].clone()
    args = (x["q"], x["k"], x["v"], x["cos"], x["sin"], kc, vc, length, x["q_norm"], x["k_norm"], EPS)
    first = df.decode_attention(*args, scratch=scratch)
    torch.cuda.synchronize()
    assert not scratch.ticket.any()
    second = df.decode_attention(*args, scratch=scratch)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and not scratch.ticket.any()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = df.decode_attention(*args, scratch=scratch)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first) and not scratch.ticket.any()


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("with_delta", [True, False], ids=["x+d", "x"])
def test_add_rms_norm_matches_plain_and_the_chain(gen, b, with_delta):
    x = _rnd(gen, b, HIDDEN, scale=3)
    d = _rnd(gen, b, HIDDEN) if with_delta else None
    w = _rnd(gen, HIDDEN, scale=0.2) + 1
    before = df.launch_counts["add_rms_norm"]
    s, y = df.add_rms_norm(x, d, w, EPS)
    torch.cuda.synchronize()
    assert df.launch_counts["add_rms_norm"] == before + 1
    s_p, y_p = df.add_rms_norm_plain(x, d, w, EPS)
    s_c = x + d if with_delta else x
    assert torch.equal(s, s_p) and torch.equal(s, s_c)
    _assert_near(y, y_p, "against the plain version")
    _assert_near(y, rms_norm(s_c, w, EPS), "against the chain")
    s2, y2 = df.add_rms_norm(x, d, w.float(), EPS)  # fp32 master weights
    _assert_near(y2, rms_norm(s_c, w.float(), EPS), "fp32 weight")


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = _inputs(gen, 1, 512)
    length = torch.tensor([100], dtype=torch.int64, device="cuda")

    def attn(**over):
        a = {**x, **over}
        return df.decode_attention(a["q"], a["k"], a["v"], a["cos"], a["sin"], a["k_cache"], a["v_cache"],
                                   over.get("length", length), a["q_norm"], a["k_norm"], EPS)

    int8 = torch.zeros(1, KVH, 512, D, dtype=torch.int8, device="cuda")
    with pytest.raises(TypeError):
        attn(k_cache=int8, v_cache=int8)  # the int8 cache runs the chain
    with pytest.raises(ValueError):
        attn(q=x["q"][..., :64].contiguous(), k=x["k"][..., :64].contiguous(), v=x["v"][..., :64].contiguous(),
             k_cache=x["k_cache"][..., :64].contiguous(), v_cache=x["v_cache"][..., :64].contiguous(),
             cos=x["cos"][:, :64].contiguous(), sin=x["sin"][:, :64].contiguous(), q_norm=x["q_norm"][:64],
             k_norm=x["k_norm"][:64])  # head dim 64
    with pytest.raises(ValueError):
        attn(q=x["q"].repeat(1, 1, 2)[..., :D])  # non-contiguous q
    with pytest.raises(ValueError):
        attn(k_cache=x["k_cache"].transpose(2, 3).contiguous().transpose(2, 3))  # cache rows not contiguous
    with pytest.raises(ValueError):
        attn(length=length.int())
    with pytest.raises(ValueError):
        attn(k_norm=None)  # one qk-norm weight without the other
    with pytest.raises(TypeError):
        attn(q=x["q"].half())
    with pytest.raises(ValueError):
        attn(q=x["q"][:, :KVH].contiguous())  # a GQA group of 1: the kernel is built for the configs' 6
    rows = _rnd(gen, 2, HIDDEN)
    w = torch.ones(HIDDEN, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        df.add_rms_norm(rows.t().contiguous().t(), None, w, EPS)  # non-contiguous rows
    with pytest.raises(TypeError):
        df.add_rms_norm(rows.float(), None, w, EPS)
    with pytest.raises(ValueError):
        df.add_rms_norm(rows[:, :1500].contiguous(), None, w[:1500], EPS)  # not a multiple of 8


def _graph_logits(lm, cache, cfg, tokens, pos0):
    """The step captured in a CUDA graph after one eager step, as the decode loop does, replayed
    with `tokens` fed in one by one (teacher forcing): each step's logits (V,) fp32."""
    batched = decoding._batched(cache)
    tok = torch.tensor([tokens[0]], dtype=torch.int64, device="cuda")
    pos = torch.tensor([pos0], dtype=torch.int64, device="cuda")
    inv = decoding._rope_inv_freq(cfg, "cuda")

    def step():
        return decoding._decode_step(lm, batched, tok, pos, cfg, torch.bfloat16, inv)

    out = [step()[0].clone()]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = step()
    for i, t in enumerate(tokens[1:], 1):
        tok.fill_(t)
        pos.fill_(pos0 + i)
        graph.replay()
        out.append(static[0].clone())
    torch.cuda.synchronize()
    return torch.stack(out)


def test_the_captured_step_on_the_kernels_equals_the_chain(gen, monkeypatch):
    """A cut-depth (4 layers), full-width bf16 model on a 1,400-row cache: greedy `generate`
    through the CUDA graph gives the chain's 64 tokens (up to a near tie of the chain's top two
    logits), and teacher-forced on them each step's logits lie within LOGIT_REL of the chain's;
    the loop counts every step as a fused one."""
    from g2vlm_tpu_torch.utils import tracing

    cfg = cut_depth_config(G2VLMConfig(), 4).llm
    lm = build_model(cut_depth_config(G2VLMConfig(), 4), device="cuda", dtype=torch.bfloat16, seed=0).language_model
    base = decoding.make_cache(cfg, CAP, torch.bfloat16)
    base.k.copy_(torch.randn(base.k.shape, generator=gen, device="cuda") * 2)
    base.v.copy_(torch.randn(base.v.shape, generator=gen, device="cuda"))
    base.length.fill_(1400)

    def fresh():
        return decoding.KVCache(base.k.clone(), base.v.clone(), None, None, base.length.clone())

    runs = {}
    for fused in (False, True):
        monkeypatch.setattr(decoding, "_runs_fused", lambda *a, fused=fused: fused)
        cache = fresh()
        with tracing.record():
            with tracing.span("chat"):
                toks, n, _ = decoding.generate(lm, cache, 17, 1400, -1, cfg, max_new_tokens=64)
        counters = tracing.requests()[-1].counters
        assert counters == {"decode.steps": 64, **({"decode.fused_steps": 64} if fused else {})}
        runs[fused] = (toks.tolist(), cache)
    tracing.clear()
    chain_toks = runs[False][0]
    logits = {}
    for fused in (False, True):
        monkeypatch.setattr(decoding, "_runs_fused", lambda *a, fused=fused: fused)
        logits[fused] = _graph_logits(lm, fresh(), cfg, [17] + chain_toks[:-1], 1400)
    want, got = logits[False], logits[True]
    assert not torch.equal(got, want)  # two paths: the roundings differ somewhere
    rel = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
    assert torch.isfinite(got).all() and rel < LOGIT_REL, rel
    top2 = want.topk(2, dim=-1).values
    same = 64  # steps whose tokens the two loops agree on
    for i, (a, b) in enumerate(zip(runs[True][0], chain_toks)):
        if a != b:
            gap = (top2[i, 0] - top2[i, 1]).item()
            assert gap <= 2 * (got[i] - want[i]).abs().max().item(), (i, a, b, gap)
            same = i
            break
    for name in ("k", "v"):  # the rows the two loops stored from the same tokens: step i's at row 1400 + i
        a, b = (getattr(runs[f][1], name)[..., 1400:1401 + same, :].float() for f in (True, False))
        assert ((a - b).abs().max() / b.abs().max()).item() < LOGIT_REL, name
