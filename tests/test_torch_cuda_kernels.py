"""The hand-written CUDA kernels (g2vlm_tpu_torch/csrc/attention_batched.cu the
batched forward K1 and its lse form K6; csrc/attention_segment.cu the segment
forward K2, its lse form K3, its two-stage schedule K4 and its int8-QK form
K8; csrc/attention_bwd.cu backwards K5, K7) against their plain PyTorch
versions, on the card in bf16 (and fp16).

Needs an NVIDIA GPU with nvcc; imports no jax. Run it on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from g2vlm_tpu_torch.models.g2vlm import SequenceBuilder
from g2vlm_tpu_torch.ops import flash_attention as fa
from g2vlm_tpu_torch.ops.masks import make_token_info

pytestmark = pytest.mark.cuda

# bf16 inputs, fp32 accumulation in both; the kernel rounds P to bf16 before
# P.V, the plain version keeps it fp32 (mean error stays ~1e-4)
MAX_ERR = 2e-2
MEAN_ERR = 1e-3


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.load_library()
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _check(got, want):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs()
    assert err.max().item() < MAX_ERR and err.mean().item() < MEAN_ERR, (err.max().item(), err.mean().item())


@pytest.mark.parametrize(
    "b,s,m,h,d,valid_kv,cross",
    [
        (32, 782, 782, 16, 64, None, False),  # DINOv2-L, one 518x294 view per batch element
        (32, 777, 777, 16, 96, None, False),  # Pi3 self attention
        (32, 777, 777, 16, 96, None, True),  # Pi3 cross attention to frame 0
        (3, 45, 37, 3, 96, 30, False),  # ragged, valid_kv cut
        (2, 17, 130, 2, 128, 129, False),
        (2, 65, 63, 1, 64, None, True),
        (4, 200, 777, 16, 96, None, True),  # S 200: the last block of a view has warpgroups without rows
    ],
)
def test_batched_kernel_matches_plain(gen, b, s, m, h, d, valid_kv, cross):
    q = _rnd(gen, b, s, h, d)
    kb = 1 if cross else b
    k = _rnd(gen, kb, m, h, d).expand(b, m, h, d)
    v = _rnd(gen, kb, m, h, d).expand(b, m, h, d)
    before = fa.launch_counts["flash_batched_attention"]
    got = fa.flash_batched_attention(q, k, v, valid_kv=valid_kv)
    assert fa.launch_counts["flash_batched_attention"] == before + 1
    want = fa.flash_batched_attention_reference(q.float(), k.float(), v.float(), valid_kv=valid_kv)
    _check(got, want)
    assert torch.equal(got, fa.flash_batched_attention(q, k, v, valid_kv=valid_kv))  # two launches, one result


@pytest.mark.parametrize("d,rows", [(64, 128), (96, 192), (128, 128)])
def test_batched_launch_shape(gen, d, rows):
    # the rows per block that tests/test_torch_fwd_launch.py walks, as the library reports them
    for dtype in (torch.bfloat16, torch.float16):
        for with_lse in (False, True):
            got_rows, per_sm = fa._batched_launch_shape(dtype, d, with_lse)
            assert got_rows == rows and per_sm >= 1


def _recon_info(n_views):
    b = SequenceBuilder(11, 12)
    b.add_text([7, 1, 2, 3, 4])
    b.add_dino_images(n_views, 21, 37)
    pre = b.build(pad_to=-(-b.curr // 256) * 256)
    return pre.token_info("cuda")


@pytest.mark.parametrize(
    "case",
    [
        dict(info=lambda: _recon_info(32), h=12, kvh=2, d=128),  # the 32-view prefill, 25,088 rows
        dict(info=lambda: make_token_info([100, 156], [40, 60, 56, 100], ["causal", "full", "causal", "noise"],
                                          pad_to=300, device="cuda"), h=4, kvh=2, d=128),
        dict(info=lambda: make_token_info([77], [30, 47], ["full", "causal"], device="cuda"), h=6, kvh=3, d=96),
        dict(info=lambda: make_token_info([50, 13], [50, 13], ["causal", "full"], pad_to=70, device="cuda"),
             h=2, kvh=1, d=64),
    ],
)
def test_segment_kernel_matches_plain(gen, case):
    info = case["info"]()
    n = info.seq_len
    q = _rnd(gen, n, case["h"], case["d"])
    k = _rnd(gen, n, case["kvh"], case["d"])
    v = _rnd(gen, n, case["kvh"], case["d"])
    got = fa.flash_segment_attention(q, k, v, info, info)
    want = fa.flash_segment_attention_reference(q.float(), k.float(), v.float(), info, info)
    _check(got, want)
    pad = info.doc_id < 0
    assert (got[pad] == 0).all()  # rows that see no key are written as 0


def test_fp16_inputs_match_plain(gen):
    q = _rnd(gen, 2, 45, 3, 96, dtype=torch.float16)
    _check(fa.flash_batched_attention(q, q, q, valid_kv=40),
           fa.flash_batched_attention_reference(q.float(), q.float(), q.float(), valid_kv=40))
    info = make_token_info([70, 30], [40, 30, 30], ["causal", "full", "causal"], pad_to=128, device="cuda")
    q = _rnd(gen, 128, 4, 64, dtype=torch.float16)
    k = _rnd(gen, 128, 2, 64, dtype=torch.float16)
    _check(fa.flash_segment_attention(q, k, k, info, info),
           fa.flash_segment_attention_reference(q.float(), k.float(), k.float(), info, info))


def test_segment_kernel_extreme_logits_stay_finite(gen):
    """Ties at enormous logits give the uniform mean, and one extreme row
    does not poison the others."""
    s, h, kvh, d = 128, 2, 2, 128
    v0 = torch.randn(d, generator=gen, device="cuda")
    v0 /= v0.norm()
    q = (50.0 * v0).expand(s, h, d).to(torch.bfloat16).contiguous()
    k = (50.0 * v0).expand(s, kvh, d).to(torch.bfloat16).contiguous()
    v = _rnd(gen, s, kvh, d)
    info = make_token_info([s], [s], ["full"], device="cuda")
    out = fa.flash_segment_attention(q, k, v, info, info)
    torch.cuda.synchronize()
    want = v.float().mean(0, keepdim=True).repeat_interleave(h // kvh, dim=1).expand(s, h, d)
    assert torch.isfinite(out).all()
    assert (out.float() - want).abs().max().item() < 1e-2

    q2 = _rnd(gen, s, h, d)
    k2 = _rnd(gen, s, kvh, d)
    q2[7] = (60.0 * v0).to(torch.bfloat16)
    k2[11] = (60.0 * v0).to(torch.bfloat16)
    out2 = fa.flash_segment_attention(q2, k2, v, info, info)
    _check(out2, fa.flash_segment_attention_reference(q2.float(), k2.float(), v.float(), info, info))


def test_wrappers_raise_on_what_the_kernel_does_not_take(gen):
    q = _rnd(gen, 2, 16, 2, 80)
    with pytest.raises(ValueError):
        fa.flash_batched_attention(q, q, q)  # head dim 80
    q = _rnd(gen, 2, 16, 2, 64, dtype=torch.float32)
    with pytest.raises(TypeError):
        fa.flash_batched_attention(q, q, q)
    q = _rnd(gen, 2, 16, 2, 64)
    with pytest.raises(ValueError):
        fa.flash_batched_attention(q, q.cpu(), q)


# backward limits relative to the plain result: dS and P are rounded to bf16
# before the second products, and the outputs once more
BWD_MAX_REL = 2e-2
BWD_MEAN_REL = 5e-3  # mean |err| against mean |ref|: the outputs alone carry one bf16 rounding (2^-9); seen 2.8e-3


def _check_grad(got, want, name):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all(), name
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    assert err.max().item() <= BWD_MAX_REL * ref.max().item(), (name, err.max().item(), ref.max().item())
    assert err.mean().item() <= BWD_MEAN_REL * ref.mean().item(), (name, err.mean().item(), ref.mean().item())


@pytest.mark.parametrize(
    "b,s,m,h,d,valid_kv,cross",
    [
        (16, 782, 782, 16, 64, None, False),  # DINOv2-L at the 16-view training batch
        (16, 777, 777, 16, 96, None, False),  # Pi3 self attention
        (16, 777, 777, 16, 96, None, True),  # Pi3 cross attention to frame 0 (batch stride 0)
        (16, 777, 777, 16, 96, 700, False),
        (3, 45, 37, 3, 96, 30, False),
        (2, 17, 130, 2, 128, 129, False),
        (2, 65, 63, 1, 64, None, True),
        (4, 200, 777, 16, 96, None, True),  # S 200: the last block of a view has warpgroups without rows
    ],
)
def test_batched_lse_and_backward_kernels_match_plain(gen, b, s, m, h, d, valid_kv, cross):
    kb = 1 if cross else b
    q = _rnd(gen, b, s, h, d).requires_grad_(True)
    k0 = _rnd(gen, kb, m, h, d).requires_grad_(True)
    v0 = _rnd(gen, kb, m, h, d).requires_grad_(True)
    dout = _rnd(gen, b, s, h, d)
    k, v = k0.expand(b, m, h, d), v0.expand(b, m, h, d)
    before = dict(fa.launch_counts)
    out = fa.flash_batched_attention(q, k, v, valid_kv=valid_kv)
    dq, dk, dv = torch.autograd.grad(out, (q, k0, v0), dout)
    for name in ("flash_batched_attention_lse", "flash_batched_attention_bwd_dq", "flash_batched_attention_bwd_dkv"):
        assert fa.launch_counts[name] == before[name] + 1, name
    with torch.no_grad():
        assert torch.equal(out, fa.flash_batched_attention(q, k, v, valid_kv=valid_kv))  # K6 out == K1 out
        out2, lse = fa._batched_forward_cuda(q, k, v, valid_kv, None, with_lse=True)
        out3, lse3 = fa._batched_forward_cuda(q, k, v, valid_kv, None, with_lse=True)
        assert torch.equal(out2, out) and torch.equal(out3, out) and torch.equal(lse3, lse)  # bitwise repeatable
        qf, kf, vf = q.float(), k.float(), v.float()
        want_out, want_lse = fa.flash_batched_attention_lse_reference(qf, kf, vf, valid_kv)
        assert (lse - want_lse).abs().max().item() < 2e-3
        # the plain backward takes the kernel's own out and lse, as the kernels do
        wq, wk, wv = fa.flash_batched_attention_bwd_reference(qf, kf, vf, out.float(), lse, dout.float(), valid_kv)
        if cross:
            wk, wv = wk.sum(0, keepdim=True), wv.sum(0, keepdim=True)
    _check_grad(dq, wq, "dq")
    _check_grad(dk, wk, "dk")
    _check_grad(dv, wv, "dv")
    if valid_kv is not None:
        assert (dk[:, valid_kv:] == 0).all() and (dv[:, valid_kv:] == 0).all()


def _train_info(n_views):
    """The sorted [und | geo] training pack: text, then the dino views."""
    b = SequenceBuilder(11, 12)
    b.add_text(list(range(20, 51)))
    b.add_dino_images(n_views, 21, 37)
    pre = b.build(pad_to=-(-b.curr // 256) * 256)
    return pre.token_info("cuda")


@pytest.mark.parametrize(
    "case",
    [
        dict(info=lambda: _train_info(16), h=12, kvh=2, d=128),  # the 16-view training pack, 12,544 rows
        dict(info=lambda: make_token_info([100, 156], [40, 60, 56, 100], ["causal", "full", "causal", "noise"],
                                          pad_to=320, device="cuda"), h=12, kvh=2, d=128),
        dict(info=lambda: make_token_info([77], [30, 47], ["full", "causal"], device="cuda"), h=6, kvh=3, d=96),
        dict(info=lambda: make_token_info([50, 13], [50, 13], ["causal", "full"], pad_to=70, device="cuda"),
             h=2, kvh=1, d=64),
    ],
)
def test_segment_lse_and_backward_kernels_match_plain(gen, case):
    info = case["info"]()
    n = info.seq_len
    q = _rnd(gen, n, case["h"], case["d"]).requires_grad_(True)
    k = _rnd(gen, n, case["kvh"], case["d"]).requires_grad_(True)
    v = _rnd(gen, n, case["kvh"], case["d"]).requires_grad_(True)
    dout = _rnd(gen, n, case["h"], case["d"])
    before = dict(fa.launch_counts)
    out = fa.flash_segment_attention(q, k, v, info, info)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    for name in ("flash_segment_attention_lse", "flash_segment_attention_bwd_dq", "flash_segment_attention_bwd_dkv"):
        assert fa.launch_counts[name] == before[name] + 1, name
    with torch.no_grad():
        assert torch.equal(out, fa.flash_segment_attention(q, k, v, info, info))  # K3 out == K2 out
        meta = info.packed()
        _, lse = fa._segment_forward_cuda(q, k, v, meta, meta, fa.block_codes(meta, meta), None, with_lse=True)
        qf, kf, vf = q.float(), k.float(), v.float()
        _, want_lse = fa.flash_segment_attention_lse_reference(qf, kf, vf, info, info)
        assert (lse - want_lse).abs().max().item() < 2e-3
        wq, wk, wv = fa.flash_segment_attention_bwd_reference(qf, kf, vf, out.float(), lse, dout.float(), info, info)
    _check_grad(dq, wq, "dq")
    _check_grad(dk, wk, "dk")
    _check_grad(dv, wv, "dv")
    pad = info.doc_id < 0
    if pad.any():  # rows and keys that see nothing: exact zeros
        assert (lse[:, pad] == fa.LSE_EMPTY).all()
        assert (dq[pad] == 0).all() and (dk[pad] == 0).all() and (dv[pad] == 0).all()


def test_fp16_backward_matches_plain(gen):
    q = _rnd(gen, 2, 45, 3, 96, dtype=torch.float16).requires_grad_(True)
    dout = _rnd(gen, 2, 45, 3, 96, dtype=torch.float16)
    out = fa.flash_batched_attention(q, q, q, valid_kv=40)
    (dq,) = torch.autograd.grad(out, q, dout)
    qf = q.detach().float().requires_grad_(True)
    ref = fa.flash_batched_attention_reference(qf, qf, qf, valid_kv=40)
    (want,) = torch.autograd.grad(ref, qf, dout.float())
    _check_grad(dq, want, "dq")


def _vit_info(n_images, per, pad=0):
    """Each image a segment of `per` rows with full attention inside it (doc = fn = image id)."""
    seg = torch.arange(n_images, device="cuda", dtype=torch.int32).repeat_interleave(per)
    seg = torch.cat([seg, torch.full((pad,), -1, device="cuda", dtype=torch.int32)])
    from g2vlm_tpu_torch.ops.masks import TokenInfo

    return TokenInfo(seg, seg, torch.full_like(seg, -1), torch.arange(len(seg), device="cuda", dtype=torch.int32))


FORWARD_CASES = [
    dict(info=lambda: _vit_info(4, 2916), h=16, kvh=16, d=80),  # one ViT chunk: 4 images of 54x54 patches
    dict(info=lambda: _vit_info(3, 100, pad=20), h=4, kvh=4, d=80),
    dict(info=lambda: make_token_info([100, 156], [40, 60, 56, 100], ["causal", "full", "causal", "noise"],
                                      pad_to=300, device="cuda"), h=12, kvh=2, d=128),
    dict(info=lambda: make_token_info([77], [30, 47], ["full", "causal"], device="cuda"), h=6, kvh=3, d=96),
    dict(info=lambda: make_token_info([50, 13], [50, 13], ["causal", "full"], pad_to=70, device="cuda"),
         h=2, kvh=1, d=64),
    dict(info=lambda: _recon_info(8), h=12, kvh=2, d=128),
]


def _qkv(gen, case, dtype=torch.bfloat16):
    info = case["info"]()
    n = info.seq_len
    return (info, _rnd(gen, n, case["h"], case["d"], dtype=dtype), _rnd(gen, n, case["kvh"], case["d"], dtype=dtype),
            _rnd(gen, n, case["kvh"], case["d"], dtype=dtype))


@pytest.mark.parametrize("case", FORWARD_CASES[:2])
def test_segment_kernel_head_dim_80_matches_plain(gen, case):
    info, q, k, v = _qkv(gen, case)
    got = fa.flash_segment_attention(q, k, v, info, info)
    _check(got, fa.flash_segment_attention_reference(q.float(), k.float(), v.float(), info, info))
    assert (got[info.doc_id < 0] == 0).all()
    # the ViT's training branch: the lse forward (K3) and the backward (K5) at this width
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    before = dict(fa.launch_counts)
    out = fa.flash_segment_attention(qg, kg, vg, info, info)
    assert torch.equal(out, got)  # K3's out is K2's
    dout = _rnd(gen, *q.shape)
    grads = torch.autograd.grad(out, (qg, kg, vg), dout)
    for name in ("flash_segment_attention_lse", "flash_segment_attention_bwd_dq", "flash_segment_attention_bwd_dkv"):
        assert fa.launch_counts[name] == before[name] + 1, name
    with torch.no_grad():
        qf, kf, vf = q.float(), k.float(), v.float()
        _, want_lse = fa.flash_segment_attention_lse_reference(qf, kf, vf, info, info)
        meta = info.packed()
        _, lse = fa._segment_forward_cuda(q, k, v, meta, meta, fa.block_codes(meta, meta), None, with_lse=True)
        assert (lse - want_lse).abs().max().item() < 2e-3
        want = fa.flash_segment_attention_bwd_reference(qf, kf, vf, out.float(), lse, dout.float(), info, info)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        _check_grad(g, w, name)
        assert (g[info.doc_id < 0] == 0).all(), name


def test_a_callers_plan_gives_the_calls_own_result(gen):
    """`segment_plan` made once and handed to K2, K4, K8 and the lse forward
    gives bitwise what each call computes with a plan of its own."""
    info, q, k, v = _qkv(gen, FORWARD_CASES[2])
    plan = fa.segment_plan(info, info)
    assert torch.equal(plan.codes, fa.block_codes(info.packed(), info.packed()))
    for kw in ({}, dict(pipelined=True)):
        assert torch.equal(fa.flash_segment_attention(q, k, v, info, info, plan=plan, **kw),
                           fa.flash_segment_attention(q, k, v, info, info, **kw))
    assert torch.equal(fa.flash_segment_attention_int8(q, k, v, info, info, plan=plan),
                       fa.flash_segment_attention_int8(q, k, v, info, info))
    dout = _rnd(gen, *q.shape)
    grads = []
    for kw in (dict(plan=plan), {}):
        qg = q.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fa.flash_segment_attention(qg, k, v, info, info, **kw), qg, dout)[0])
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("case", FORWARD_CASES)
def test_pipelined_kernel_equals_the_plain_schedule(gen, case):
    """K4 computes K2's function: equal to K2's output to rounding (1e-3), and
    against the plain version within the forward limits."""
    info, q, k, v = _qkv(gen, case)
    before = dict(fa.launch_counts)
    got = fa.flash_segment_attention(q, k, v, info, info, pipelined=True)
    assert fa.launch_counts["flash_segment_attention_pipe"] == before["flash_segment_attention_pipe"] + 1
    assert fa.launch_counts["flash_segment_attention"] == before["flash_segment_attention"]
    base = fa.flash_segment_attention(q, k, v, info, info)
    torch.cuda.synchronize()
    assert (got.float() - base.float()).abs().max().item() <= 1e-3
    _check(got, fa.flash_segment_attention_reference(q.float(), k.float(), v.float(), info, info))
    assert (got[info.doc_id < 0] == 0).all()
    # with lse: K3's function, and the K5 backward behind it
    meta = info.packed()
    codes = fa.block_codes(meta, meta)
    out, lse = fa._segment_forward_cuda(q, k, v, meta, meta, codes, None, with_lse=True, pipelined=True)
    _, lse3 = fa._segment_forward_cuda(q, k, v, meta, meta, codes, None, with_lse=True)
    assert torch.equal(out, got)
    assert (lse - lse3).abs().max().item() <= 1e-5 * max(1.0, lse3[lse3 > -1e29].abs().max().item())
    qg = q.clone().requires_grad_(True)
    dout = _rnd(gen, *q.shape)
    (dq,) = torch.autograd.grad(fa.flash_segment_attention(qg, k, v, info, info, pipelined=True), qg, dout)
    qg2 = q.clone().requires_grad_(True)
    (dq2,) = torch.autograd.grad(fa.flash_segment_attention(qg2, k, v, info, info), qg2, dout)
    _check_grad(dq, dq2, "dq through the pipelined forward")


def test_pipelined_kernel_fp16_and_extreme_logits(gen):
    info, q, k, v = _qkv(gen, FORWARD_CASES[4], dtype=torch.float16)
    _check(fa.flash_segment_attention(q, k, v, info, info, pipelined=True),
           fa.flash_segment_attention_reference(q.float(), k.float(), v.float(), info, info))
    s, h, kvh, d = 128, 2, 2, 128
    v0 = torch.randn(d, generator=gen, device="cuda")
    v0 /= v0.norm()
    q = (50.0 * v0).expand(s, h, d).to(torch.bfloat16).contiguous()
    v = _rnd(gen, s, kvh, d)
    info = make_token_info([s], [s], ["full"], device="cuda")
    out = fa.flash_segment_attention(q, q.clone(), v, info, info, pipelined=True)
    want = v.float().mean(0, keepdim=True).expand(s, h, d)
    assert torch.isfinite(out).all() and (out.float() - want).abs().max().item() < 1e-2


@pytest.mark.parametrize("had,kmean", [(True, True), (False, False)])
@pytest.mark.parametrize("case", FORWARD_CASES)
def test_int8_kernel_matches_its_plain_version(gen, case, had, kmean):
    """K8 against its own plain version (same quantiser, exact integer QK^T),
    and within the quantisation budget of the unquantised attention."""
    info, q, k, v = _qkv(gen, case)
    before = fa.launch_counts["flash_segment_attention_int8"]
    got = fa.flash_segment_attention_int8(q, k, v, info, info, hadamard=had, kmean=kmean)
    assert fa.launch_counts["flash_segment_attention_int8"] == before + 1
    meta = info.packed()
    q8, qs, k8, ks = fa.quantize_qk(q, k, meta, None, had, kmean)
    _check(got, fa._int8_attention_plain(q8, qs, k8, ks, v.float(), info, info))
    assert (got[info.doc_id < 0] == 0).all()
    ref = fa.flash_segment_attention_reference(q.float(), k.float(), v.float(), info, info)
    assert (got.float() - ref).abs().max().item() <= 2e-2 * ref.abs().max().item() + 2e-2


def test_int8_kernel_outliers_common_mode_and_extreme_logits(gen):
    """An outlier channel (Hadamard spreads it), a common-mode K offset (the
    K-mean removes it) and logits of hundreds of nats (finite)."""
    info = make_token_info([256], [256], ["causal"], pad_to=300, device="cuda")
    n, h, kvh, d = 300, 4, 2, 128
    q, k, v = _rnd(gen, n, h, d), _rnd(gen, n, kvh, d), _rnd(gen, n, kvh, d)
    q[:, :, 5] *= 20.0
    k = (k.float() + 8.0 * torch.randn(1, kvh, d, generator=gen, device="cuda")).to(torch.bfloat16)
    got = fa.flash_segment_attention_int8(q, k, v, info, info)
    q8, qs, k8, ks = fa.quantize_qk(q, k, info.packed())
    _check(got, fa._int8_attention_plain(q8, qs, k8, ks, v.float(), info, info))
    v0 = torch.randn(d, generator=gen, device="cuda")
    v0 /= v0.norm()
    q2, k2 = _rnd(gen, n, h, d), _rnd(gen, n, kvh, d)
    q2[7] = (60.0 * v0).to(torch.bfloat16)
    k2[3] = (60.0 * v0).to(torch.bfloat16)
    out = fa.flash_segment_attention_int8(q2, k2, v, info, info)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    with pytest.raises(RuntimeError):
        fa.flash_segment_attention_int8(q.clone().requires_grad_(True), k, v, info, info)


# the backward kernels' tiles: 64 query rows per warpgroup, 128 keys per dkv block, ring of stages
BWD_TILE_CASES = [
    # (sample lens, split lens, modes, pad_to, h, kvh, d, dtype)
    ([200, 120], [80, 120, 50, 70], ["causal", "full", "causal", "full"], 333, 12, 2, 128, torch.bfloat16),
    ([100, 156], [40, 60, 56, 100], ["causal", "full", "causal", "noise"], 384, 6, 2, 96, torch.bfloat16),
    ([50, 13], [50, 13], ["causal", "full"], 70, 4, 2, 64, torch.bfloat16),
    ([150, 50], [100, 50, 50], ["full", "causal", "full"], 200, 12, 2, 128, torch.float16),
    ([77], [30, 47], ["full", "causal"], 77, 3, 3, 96, torch.float16),
    ([200, 120], [80, 120, 50, 70], ["causal", "full", "causal", "full"], 333, 4, 4, 80, torch.bfloat16),
    ([100, 156], [40, 60, 56, 100], ["causal", "full", "causal", "noise"], 384, 6, 2, 80, torch.float16),
]


def _segment_bwd_inputs(gen, case):
    lens, splits, modes, pad_to, h, kvh, d, dtype = case
    info = make_token_info(lens, splits, modes, pad_to=pad_to, device="cuda")
    n = info.seq_len
    q, k, v, dout = (_rnd(gen, n, heads, d, dtype=dtype) for heads in (h, kvh, kvh, h))
    meta = info.packed()
    codes = fa.block_codes(meta, meta)
    out, lse = fa._segment_forward_cuda(q, k, v, meta, meta, codes, None, with_lse=True)
    return info, (q, k, v, out, lse, dout, meta, meta, codes)


@pytest.mark.parametrize("case", BWD_TILE_CASES, ids=["ragged_333", "skip_tiles_g3_d96", "g2_d64", "fp16_d128",
                                                      "fp16_g1_d96", "ragged_g1_d80", "fp16_skip_tiles_g3_d80"])
def test_segment_backward_tiles_repeatable_and_match_plain(gen, case):
    """Ragged tails, head dims 64 / 80 / 96 / 128, odd and even GQA groups, fp16: the kernels match
    the plain backward, two launches agree bit for bit, and rows that see nothing get zeros."""
    info, args = _segment_bwd_inputs(gen, case)
    q, k, v, out, lse, dout = args[:6]
    got = fa._segment_backward_cuda(*args, None)
    again = fa._segment_backward_cuda(*args, None)
    for name, g, w in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(g, w), name
    want = fa.flash_segment_attention_bwd_reference(q.float(), k.float(), v.float(), out.float(), lse,
                                                    dout.float(), info, info)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _check_grad(g, w, name)
    pad = info.doc_id < 0
    assert all((g[pad] == 0).all() for g in got)


@pytest.mark.parametrize("n_split", [1, 2, 3, 6])
def test_dkv_group_split_matches_the_whole_group(gen, n_split, monkeypatch):
    """Each cut of the 12:2 group into slices of query heads (fp32 partial sums added in slice
    order by a second kernel) gives the plain backward's dk and dv, bitwise the same twice."""
    info, args = _segment_bwd_inputs(gen, BWD_TILE_CASES[0])
    q, k, v, out, lse, dout = args[:6]
    monkeypatch.setattr(fa, "dkv_head_split", lambda *shape: n_split)
    _, dk, dv = fa._segment_backward_cuda(*args, None, which=("dkv",))
    _, dk2, dv2 = fa._segment_backward_cuda(*args, None, which=("dkv",))
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    _, wk, wv = fa.flash_segment_attention_bwd_reference(q.float(), k.float(), v.float(), out.float(), lse,
                                                         dout.float(), info, info)
    _check_grad(dk, wk, "dk")
    _check_grad(dv, wv, "dv")


@pytest.mark.parametrize(
    "b,s,m,h,d,valid_kv,dtype",
    [
        (16, 782, 782, 16, 64, None, torch.bfloat16),  # DINOv2-L at the training batch: 782 = 12 x 64 + 14
        (2, 130, 259, 3, 96, 200, torch.bfloat16),  # the dkv kernel's last block of 128 keys half masked
        (3, 65, 129, 2, 128, None, torch.float16),
    ],
)
def test_batched_backward_repeatable_at_ragged_shapes(gen, b, s, m, h, d, valid_kv, dtype):
    q, dout = _rnd(gen, b, s, h, d, dtype=dtype), _rnd(gen, b, s, h, d, dtype=dtype)
    k, v = _rnd(gen, b, m, h, d, dtype=dtype), _rnd(gen, b, m, h, d, dtype=dtype)
    out, lse = fa._batched_forward_cuda(q, k, v, valid_kv, None, with_lse=True)
    got = fa._batched_backward_cuda(q, k, v, out, lse, dout, valid_kv, None)
    again = fa._batched_backward_cuda(q, k, v, out, lse, dout, valid_kv, None)
    for name, g, w in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(g, w), name
    want = fa.flash_batched_attention_bwd_reference(q.float(), k.float(), v.float(), out.float(), lse,
                                                    dout.float(), valid_kv)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _check_grad(g, w, name)
    if valid_kv is not None:
        assert (got[1][:, valid_kv:] == 0).all() and (got[2][:, valid_kv:] == 0).all()


# the segment forwards' packs: a ragged one (333 rows: no multiple of the 64-row tiles) and one
# whose codes hold SKIP (its last two tiles are padding: whole rows and columns of SKIP tiles),
# PARTIAL and FULL; both end in padding rows that see no key
SEGMENT_PACKS = {
    "ragged_333": lambda: make_token_info([200, 120], [80, 120, 50, 70], ["causal", "full", "causal", "full"],
                                          pad_to=333, device="cuda"),
    "skip_partial_full": lambda: make_token_info([100, 156], [40, 60, 56, 100], ["causal", "full", "causal", "noise"],
                                                 pad_to=384, device="cuda"),
}
# (h, kvh): a 12:2 group shared by 2 or 3 warpgroups, an odd group, and G = 1 (consecutive query tiles)
SEGMENT_HEADS = {"12:2": (12, 2), "6:2": (6, 2), "4:4": (4, 4)}


@pytest.mark.parametrize("heads", list(SEGMENT_HEADS.values()), ids=list(SEGMENT_HEADS))
@pytest.mark.parametrize("pack", list(SEGMENT_PACKS), ids=list(SEGMENT_PACKS))
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_segment_forwards_match_plain_and_repeat(gen, d, pack, heads):
    """K2, K3 and K4 against their plain versions at every head dim, on a ragged pack and on one
    with SKIP, PARTIAL and FULL tiles: two launches bitwise equal, K3's out bitwise K2's, K4
    within 1e-3 of K2, and rows that see no key written as 0 with lse LSE_EMPTY."""
    info = SEGMENT_PACKS[pack]()
    codes = fa.block_codes(info.packed(), info.packed())
    if pack == "skip_partial_full":
        assert set(codes.unique().tolist()) == {fa.BLOCK_SKIP, fa.BLOCK_PARTIAL, fa.BLOCK_FULL}
    h, kvh = heads
    n = info.seq_len
    q, k, v = _rnd(gen, n, h, d), _rnd(gen, n, kvh, d), _rnd(gen, n, kvh, d)
    pad = info.doc_id < 0
    assert pad.any()
    want = fa.flash_segment_attention_reference(q.float(), k.float(), v.float(), info, info)
    out = fa.flash_segment_attention(q, k, v, info, info)
    assert torch.equal(out, fa.flash_segment_attention(q, k, v, info, info))
    _check(out, want)
    assert (out[pad] == 0).all()
    pipe = fa.flash_segment_attention(q, k, v, info, info, pipelined=True)
    assert torch.equal(pipe, fa.flash_segment_attention(q, k, v, info, info, pipelined=True))
    _check(pipe, want)
    assert (pipe.float() - out.float()).abs().max().item() <= 1e-3 and (pipe[pad] == 0).all()
    # the lse forwards, serial (K3) and pipelined (K4 with lse)
    meta = info.packed()
    _, want_lse = fa.flash_segment_attention_lse_reference(q.float(), k.float(), v.float(), info, info)
    for pipelined, base in ((False, out), (True, pipe)):
        out3, lse = fa._segment_forward_cuda(q, k, v, meta, meta, codes, None, with_lse=True, pipelined=pipelined)
        out4, lse4 = fa._segment_forward_cuda(q, k, v, meta, meta, codes, None, with_lse=True,
                                              pipelined=pipelined)
        assert torch.equal(out3, base) and torch.equal(out4, out3) and torch.equal(lse4, lse)
        assert (lse - want_lse).abs().max().item() < 2e-3
        assert (lse[:, pad] == fa.LSE_EMPTY).all()



# K8's head layouts: the chat prefill's 12:2 (3 heads of a group a block), an odd 6:2, and the ViT's
# 16:16 (3 consecutive query tiles of one head a block)
INT8_HEADS = {"12:2": (12, 2), "6:2": (6, 2), "16:16": (16, 16)}


@pytest.mark.parametrize("had,kmean", [(True, True), (False, False)], ids=["had_kmean", "neither"])
@pytest.mark.parametrize("heads", list(INT8_HEADS.values()), ids=list(INT8_HEADS))
@pytest.mark.parametrize("pack", list(SEGMENT_PACKS), ids=list(SEGMENT_PACKS))
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_int8_forward_matches_plain_and_repeats(gen, d, pack, heads, had, kmean):
    """K8 (the s8 wgmma S on K2's ring) against its plain version at every head dim, on the ragged
    pack and the SKIP / PARTIAL / FULL pack, with both quantiser settings: two launches bitwise
    equal, and rows that see no key written as 0."""
    info = SEGMENT_PACKS[pack]()
    h, kvh = heads
    n = info.seq_len
    q, k, v = _rnd(gen, n, h, d), _rnd(gen, n, kvh, d), _rnd(gen, n, kvh, d)
    plan = fa.segment_plan(info, info)
    q8, qs, k8, ks = fa.quantize_qk(q, k, plan.kv_meta, None, had, kmean)
    before = fa.launch_counts["flash_segment_attention_int8"]
    got = fa._int8_forward_cuda(q8, qs, k8, ks, v, *plan)
    assert fa.launch_counts["flash_segment_attention_int8"] == before + 1
    assert torch.equal(got, fa._int8_forward_cuda(q8, qs, k8, ks, v, *plan))
    assert torch.equal(got, fa.flash_segment_attention_int8(q, k, v, info, info, hadamard=had, kmean=kmean))
    _check(got, fa._int8_attention_plain(q8, qs, k8, ks, v.float(), info, info))
    pad = info.doc_id < 0
    assert pad.any() and (got[pad] == 0).all()


# K2 / K3's warp-specialised schedule at head dim 128 (a TMA producer warpgroup and two consumer
# warpgroups taking turns on the tensor cores). Packs: recon-like (nearly every tile FULL), the three
# packs of tests/test_torch_ops.py::test_block_codes_match_jax (SKIP, PARTIAL and FULL tiles; the last
# ends in padding rows that see no key), and the ragged 333 and 65 rows
WS_PACKS = {
    "recon_8_views": lambda: _recon_info(8),
    "codes_case0": lambda: make_token_info([96], [96], ["causal"], device="cuda"),
    "codes_case1": lambda: make_token_info([100, 156], [40, 60, 56, 100], ["causal", "full", "causal", "full"],
                                           device="cuda"),
    "codes_case2": lambda: make_token_info([70, 130], [30, 40, 50, 80], ["causal", "noise", "full", "noise"],
                                           pad_to=237, device="cuda"),
    "ragged_333": SEGMENT_PACKS["ragged_333"],
    "ragged_65": lambda: make_token_info([50, 13], [50, 13], ["causal", "full"], pad_to=65, device="cuda"),
}
# G even (two heads of a group on the same rows a block) and G odd (two query tiles of one head a block)
WS_HEADS = {"12:2": (12, 2), "4:2": (4, 2), "6:2": (6, 2), "2:2": (2, 2)}


def _ws_forwards(q, k, v, info, kv_info=None):
    """K2 and K3 through the wrappers: (out, out of K3, lse), each launched twice and held bitwise equal,
    and one warp-specialised launch counted for each."""
    kv_info = info if kv_info is None else kv_info
    plan = fa.segment_plan(info, kv_info)
    before = fa.launch_counts["flash_segment_attention_ws"]
    out = fa.flash_segment_attention(q, k, v, info, kv_info, plan=plan)
    out3, lse = fa._segment_forward_cuda(q, k, v, *plan, None, with_lse=True)
    assert torch.equal(out, fa.flash_segment_attention(q, k, v, info, kv_info, plan=plan))
    again3, again_lse = fa._segment_forward_cuda(q, k, v, *plan, None, with_lse=True)
    assert torch.equal(out3, again3) and torch.equal(lse, again_lse)
    assert fa.launch_counts["flash_segment_attention_ws"] == before + 4
    return out, out3, lse


@pytest.mark.parametrize("heads", list(WS_HEADS.values()), ids=list(WS_HEADS))
@pytest.mark.parametrize("pack", list(WS_PACKS), ids=list(WS_PACKS))
def test_warp_specialised_forwards_match_plain_and_repeat(gen, pack, heads):
    """K2 and K3 at head dim 128 against their plain versions: out within the forward limits, K3's out
    bitwise K2's, lse within 2e-3, two launches bitwise equal, rows that see no key written as 0 with
    lse LSE_EMPTY; and bitwise K4's out, whose lockstep schedule does the same arithmetic."""
    info = WS_PACKS[pack]()
    h, kvh = heads
    n = info.seq_len
    q, k, v = _rnd(gen, n, h, 128), _rnd(gen, n, kvh, 128), _rnd(gen, n, kvh, 128)
    out, out3, lse = _ws_forwards(q, k, v, info)
    want, want_lse = fa.flash_segment_attention_lse_reference(q.float(), k.float(), v.float(), info, info)
    _check(out, want)
    assert torch.equal(out3, out)
    assert (lse - want_lse).abs().max().item() < 2e-3
    pad = info.doc_id < 0
    assert (out[pad] == 0).all() and (lse[:, pad] == fa.LSE_EMPTY).all()
    assert torch.equal(out, fa.flash_segment_attention(q, k, v, info, info, pipelined=True))


@pytest.mark.parametrize("shards", [2, 4])
def test_warp_specialised_query_shard_equals_the_whole_launch(gen, shards):
    """A sequence-parallel rank's query rows (S / n of them) against all S keys: bitwise the rows of the
    unsharded launch, out and lse, on every shard."""
    info = _recon_info(8)
    n = info.seq_len
    q, k, v = _rnd(gen, n, 12, 128), _rnd(gen, n, 2, 128), _rnd(gen, n, 2, 128)
    out, _, lse = _ws_forwards(q, k, v, info)
    rows = n // shards
    for r in range(shards):
        local = info.slice(r * rows, rows)
        got, got3, got_lse = _ws_forwards(q[r * rows:(r + 1) * rows], k, v, local, info)
        assert torch.equal(got, out[r * rows:(r + 1) * rows]) and torch.equal(got3, got)
        assert torch.equal(got_lse, lse[:, r * rows:(r + 1) * rows])


def test_warp_specialised_fp16_and_extreme_logits(gen):
    """fp16 inputs against the plain version; ties at enormous logits give the uniform mean, and one
    extreme row does not poison the others."""
    info = WS_PACKS["codes_case2"]()
    n = info.seq_len
    q, k, v = (_rnd(gen, n, h, 128, dtype=torch.float16) for h in (4, 2, 2))
    out, _, lse = _ws_forwards(q, k, v, info)
    want, want_lse = fa.flash_segment_attention_lse_reference(q.float(), k.float(), v.float(), info, info)
    _check(out, want)
    assert out.dtype == torch.float16 and (lse - want_lse).abs().max().item() < 2e-3

    s, h, kvh, d = 192, 4, 2, 128
    v0 = torch.randn(d, generator=gen, device="cuda")
    v0 /= v0.norm()
    q = (50.0 * v0).expand(s, h, d).to(torch.bfloat16).contiguous()
    v = _rnd(gen, s, kvh, d)
    full = make_token_info([s], [s], ["full"], device="cuda")
    out, _, _ = _ws_forwards(q, q[:, :kvh].clone(), v, full)
    want = v.float().mean(0, keepdim=True).repeat_interleave(h // kvh, dim=1).expand(s, h, d)
    assert torch.isfinite(out).all() and (out.float() - want).abs().max().item() < 1e-2
    q2, k2 = _rnd(gen, s, h, d), _rnd(gen, s, kvh, d)
    q2[7] = (60.0 * v0).to(torch.bfloat16)
    k2[11] = (60.0 * v0).to(torch.bfloat16)
    out2, _, _ = _ws_forwards(q2, k2, v, full)
    _check(out2, fa.flash_segment_attention_reference(q2.float(), k2.float(), v.float(), full, full))
