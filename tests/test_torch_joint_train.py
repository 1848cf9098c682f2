"""The ViT branch of the port's training step against g2vlm_tpu's on the CPU
in fp32 at tiny widths: `train_forward` on a joint pack (DINOv2 views and
ViT images laid out by the packer, padded ViT slots included) and every
parameter's gradient against `jax.grad`, MIXED and SPLIT; the freeze labels
with the ViT against the JAX package's; `encode_packed` with per-block
checkpointing equal to without."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vlm_tpu.config import tiny_test_config as jax_tiny_config
from g2vlm_tpu.models import g2vlm as jg
from g2vlm_tpu.train import trainer as jtr
from g2vlm_tpu_torch.config import tiny_test_config
from g2vlm_tpu_torch.data.packing import PackerConfig, SequencePacker
from g2vlm_tpu_torch.data.vit_preprocess import preprocess_vit_image_fast
from g2vlm_tpu_torch.models import qwen_vit
from g2vlm_tpu_torch.train import trainer as ttr
from g2vlm_tpu_torch.weights import build_model, state_dict_from_jax

JCFG = jax_tiny_config()
CFG = tiny_test_config()
H, W = 42, 56  # DINOv2 views: 3 x 4 patches
S, MAX_VIT = 96, 48  # the pack, and ViT slots for three images of 16 patch rows (two used)
TOKEN_IDS = dict(bos_token_id=500, eos_token_id=501, start_of_image=502, end_of_image=503)
# the L1 alignment's pivot pixel (tests/test_torch_trainer.py: JAX_GRAD_REL)
JAX_GRAD_REL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """This module runs many small torch ops, which torch spreads over one thread per core by
    default; beside the other test workers that oversubscribes the machine (1.7x slower on one
    core), so the module runs on two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_params(seed=0):
    rng = np.random.default_rng(seed)
    params = jg.init_params(JCFG, jax.random.PRNGKey(seed))
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)
    for head in ("point_head", "global_point_head"):
        params[head]["proj"]["w"] = params[head]["proj"]["w"] * np.float32(0.1)
    return params


def _pack(sorted_layout, seed=1):
    """One joint pack from the port's packer: a prompt, two DINOv2 views (positive depths, random
    rigid cameras), two ViT images, a question and an answer with the loss; ViT slots for one more
    image, so its four merged slots are padding (index S)."""
    rng = np.random.default_rng(seed)
    views = []
    for i in range(2):
        local = rng.standard_normal((H, W, 3)).astype(np.float32)
        local[..., 2] = np.abs(local[..., 2]) + 1.5
        c2w = np.eye(4, dtype=np.float32)
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        c2w[:3, :3], c2w[:3, 3] = q * np.sign(np.linalg.det(q)), 0.3 * rng.standard_normal(3)
        views.append(dict(image=rng.integers(0, 256, (H, W, 3), dtype=np.uint8), extrinsics=c2w,
                          world_points=(local @ c2w[:3, :3].T + c2w[:3, 3]).astype(np.float32),
                          point_masks=rng.random((H, W)) < 0.9))
    vit = [dict(zip(("patches", "grid_thw"), preprocess_vit_image_fast(
        rng.integers(0, 256, (64, 80, 3), dtype=np.uint8), (56, 56)))) for _ in range(2)]
    plan = ([{"type": "text"}] + [{"type": "dino_image"}] * 2 + [{"type": "vit_image"}] * 2
            + [{"type": "text"}, {"type": "text", "loss": 1}])
    text = [list(rng.integers(20, 400, n)) for n in (4, 5, 6)]
    packer = SequencePacker(PackerConfig(max_num_tokens=S, max_ce_slots=16, max_vit_patches=MAX_VIT), TOKEN_IDS)
    packer.add_sample(dict(plan=plan, text_ids_list=text, dino_views=views, vit_views=vit), random.Random(seed))
    b = packer.to_batch(None, sorted_layout=sorted_layout, geo_start_bucket=16)
    fields = {k: b[k] for k in ("text_ids", "text_indexes", "dino_indexes", "vit_indexes", "is_geo", "position_ids",
                                "doc_id", "fn_id", "noise_id", "pos", "ce_indexes", "ce_labels", "ce_weights",
                                "dino_images", "vit_patches", "vit_coords", "vit_seg")}
    fields.update(world_points=b["world_points"][None], point_masks=b["point_masks"][None],
                  extrinsics=b["extrinsics"][None], normal_batch_mask=np.ones((1,), bool))
    assert (fields["vit_indexes"] == S).sum() == 4 and (fields["vit_seg"] < 0).sum() == 16
    return fields, b.get("geo_start")


def _fresh_model(params):
    model = build_model(CFG, device="cpu", seed=None).train()
    model.load_state_dict(state_dict_from_jax(params, CFG), strict=True)
    return model


@pytest.mark.parametrize("sorted_layout", [False, True], ids=["mixed", "split"])
def test_vit_branch_loss_and_every_gradient_match_jax(sorted_layout):
    params = _random_params()
    fields, geo_start = _pack(sorted_layout)

    def jloss(p):
        batch = jtr.TrainBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
        return jtr.train_forward(p, batch, JCFG, compute_dtype=jnp.float32, remat=False, geo_start=geo_start)

    (want, wdet), wgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jax.tree.map(jnp.asarray, params))
    want_grads = state_dict_from_jax(jax.tree.map(np.asarray, wgrads), CFG)
    model = _fresh_model(params)
    got, gdet = ttr.train_forward(model, ttr.TrainBatch.from_numpy(**fields), CFG, compute_dtype=torch.float32,
                                  remat=False, geo_start=geo_start)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    for key in wdet:
        np.testing.assert_allclose(gdet[key].item(), float(wdet[key]), rtol=1e-4, atol=1e-6, err_msg=key)
    got.backward()
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    vit_moved = 0
    for name, p in named.items():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = np.abs(g.numpy() - want_grads[name].numpy()).max()
        assert err <= JAX_GRAD_REL * np.abs(want_grads[name].numpy()).max() + 1e-6, (name, err)
        vit_moved += name.startswith("vit_model.") and bool(g.abs().max() > 0)
    assert vit_moved == sum(n.startswith("vit_model.") for n in named)  # every ViT leaf got a gradient

    # recomputed per layer and per ViT block in the backward: the same arithmetic
    plain = {n: p.grad.clone() for n, p in named.items() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    again, _ = ttr.train_forward(model, ttr.TrainBatch.from_numpy(**fields), CFG, compute_dtype=torch.float32,
                                 remat=True, geo_start=geo_start)
    np.testing.assert_allclose(again.item(), got.item(), rtol=1e-6)
    again.backward()
    for name, g in plain.items():
        err = (named[name].grad - g).abs().max().item()
        assert err <= 1e-6 * g.abs().max().item() + 1e-7, (name, err)


@pytest.mark.parametrize("freeze_und,freeze_recon", [(True, False), (False, True), (True, True), (False, False)])
def test_freeze_labels_with_the_vit_match_jax(freeze_und, freeze_recon):
    params = _random_params()
    labels = jtr.freeze_labels(params, freeze_und, freeze_recon)
    as_arrays = jax.tree.map(lambda lab, p: np.full(np.shape(p), lab == "train", np.float32), labels, params)
    want = state_dict_from_jax(as_arrays, CFG)
    model = build_model(CFG, device="cpu", seed=0)
    got = ttr.apply_freeze(model, freeze_und, freeze_recon)
    assert set(got) == set(want)
    for name, mask in want.items():
        assert mask.min() == mask.max(), name
        assert got[name] == ("train" if mask.max() == 1 else "frozen"), (name, got[name])
        assert dict(model.named_parameters())[name].requires_grad == (got[name] == "train")
    assert any(n.startswith("vit_model.") for n in got)


def test_encode_packed_with_per_block_checkpoints_equals_without(rng):
    model = build_model(CFG, device="cpu", seed=0).train()
    views = [dict(zip(("patches", "grid_thw"), preprocess_vit_image_fast(
        rng.integers(0, 256, hw + (3,), dtype=np.uint8), (56, 84)))) for hw in ((40, 60), (70, 50))]
    pats, coords, seg, _ = qwen_vit.pack_views(views, pad_to=112)
    grads, outs = [], []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        out = qwen_vit.encode_packed(model.vit_model, torch.from_numpy(pats), torch.from_numpy(coords),
                                     torch.from_numpy(seg), torch.float32, remat=remat)
        (out[: (seg >= 0).sum() // 4] ** 2).sum().backward()
        outs.append(out.detach())
        grads.append({n: p.grad.clone() for n, p in model.vit_model.named_parameters()})
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-6, atol=1e-7, msg=name)
