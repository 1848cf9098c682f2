"""Shared pieces of the port's tests of the model alternates (the dense and
MoE decoder layers, the conf head with the SegFormer, DINOv3): configs of
both packages that differ from tiny_test_config in one field, perturbed JAX
parameters, one packed training sample as numpy fields, the per-leaf gradient
check and the two-thread fixture."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from g2vlm_tpu.config import tiny_test_config as jax_tiny_config
from g2vlm_tpu.models import g2vlm as jg
from g2vlm_tpu_torch.config import tiny_test_config
from g2vlm_tpu_torch.models import g2vlm as tg

# the L1 alignment's pivot pixel moves every gradient upstream of the point loss by up to ~7e-4
# of its largest entry (tests/test_torch_trainer.py: JAX_GRAD_REL)
JAX_GRAD_REL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Many small torch ops: on one thread per core beside the other test workers the machine is
    oversubscribed, so these modules run on two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def configs(visual_und=False, vocab_size=None, **top):
    """(JAX config, port config): tiny_test_config with `top` replaced at the
    top level; `layer_module` is taken into the LLM config."""
    out = []
    for make in (jax_tiny_config, tiny_test_config):
        cfg = make(visual_und=visual_und)
        llm = cfg.llm
        if "layer_module" in top:
            llm = dataclasses.replace(llm, layer_module=top["layer_module"])
        if vocab_size:
            llm = dataclasses.replace(llm, vocab_size=vocab_size)
        out.append(dataclasses.replace(cfg, llm=llm, **{k: v for k, v in top.items() if k != "layer_module"}))
    return tuple(out)


def perturbed(tree, seed=0, scale=0.05):
    """Every leaf of a JAX parameter tree plus N(0, scale^2) noise, as numpy fp32; the point
    heads' projections scaled down so that exp(z) stays O(10)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape)).astype(np.float32), tree)
    for head in ("point_head", "global_point_head"):
        if isinstance(out, dict) and head in out:
            out[head]["proj"]["w"] = out[head]["proj"]["w"] * np.float32(0.1)
    return out


def random_params(jcfg, seed=0):
    return perturbed(jg.init_params(jcfg, jax.random.PRNGKey(seed)), seed)


def batch_fields(cfg, seed, n=2, h=56, w=70, sorted_layout=False, patch=None):
    """One packed training sample as numpy fields, and geo_start (None unless sorted):
    positive camera-frame depths, ~90% valid pixels, random rigid extrinsics."""
    rng = np.random.default_rng(seed)
    p = patch or cfg.dino_patch_size
    b = tg.SequenceBuilder(11, 12)
    if sorted_layout:
        b.add_text([7, 23, 45] + list(rng.integers(20, 400, 5)))
        ce_idx = np.arange(b.curr - 3, b.curr)
        geo_start = b.curr
        b.add_dino_images(n, h // p, w // p)
    else:
        b.add_text([7, 23, 45])
        b.add_dino_images(n, h // p, w // p)
        b.add_text(list(rng.integers(20, 400, 5)))
        ce_idx = np.arange(b.curr - 3, b.curr)
        geo_start = None
    pre = b.build(pad_to=-(-b.curr // 32) * 32)
    local = rng.standard_normal((n, h, w, 3)).astype(np.float32)
    local[..., 2] = np.abs(local[..., 2]) + 1.5
    extr = np.tile(np.eye(4, dtype=np.float32), (1, n, 1, 1))
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    extr[0, :, :3, :3] = q * np.sign(np.linalg.det(q))[:, None, None]
    extr[0, :, :3, 3] = 0.3 * rng.standard_normal((n, 3))
    world = (np.einsum("nij,nhwj->nhwi", extr[0, :, :3, :3], local) + extr[0, :, None, None, :3, 3])[None]
    fields = dict(
        text_ids=pre.text_ids.astype(np.int32), text_indexes=pre.text_indexes.astype(np.int32),
        dino_indexes=pre.dino_indexes.astype(np.int32), vit_indexes=np.zeros((0,), np.int32),
        is_geo=pre.is_geo, position_ids=pre.position_ids,
        doc_id=pre.doc_id, fn_id=pre.fn_id, noise_id=pre.noise_id, pos=pre.pos,
        ce_indexes=ce_idx.astype(np.int32),
        ce_labels=rng.integers(0, cfg.llm.vocab_size, 3).astype(np.int32),
        ce_weights=np.asarray([1.0, 0.5, 2.0], np.float32),
        dino_images=(0.3 * rng.standard_normal((n, 3, h, w))).astype(np.float32),
        world_points=world.astype(np.float32), point_masks=rng.random((1, n, h, w)) < 0.9,
        extrinsics=extr, normal_batch_mask=np.ones((1,), bool),
    )
    return fields, geo_start


def assert_every_gradient_matches(model, want_grads, rel=JAX_GRAD_REL):
    """Each parameter's gradient (0 where none was built) against the JAX one mapped into the
    port's names, within `rel` of the leaf's largest entry; the frozen ones (requires_grad off)
    must have none. Returns the names that got a non-zero gradient."""
    named = dict(model.named_parameters())
    moved = set()
    for name, p in named.items():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        g = torch.zeros_like(p) if p.grad is None else p.grad
        want = want_grads[name].numpy()
        err = np.abs(g.numpy() - want).max()
        assert err <= rel * np.abs(want).max() + 1e-6, (name, err, np.abs(want).max())
        if g.abs().max() > 0:
            moved.add(name)
    return moved
