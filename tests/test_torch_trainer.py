"""The port's training step against g2vlm_tpu's on the CPU in fp32 at tiny
widths: `train_forward` in MIXED and SPLIT, every parameter's gradient against
`jax.grad` (mapped through `state_dict_from_jax`), checkpointing, the
optimizer against optax on given gradients, whole `train_step`s with AdamW and
with factored Adam + bf16 first moment, EMA and freezing, and the
`train_torch.py` entry point."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from g2vlm_tpu.config import tiny_test_config
from g2vlm_tpu.models import g2vlm as jg
from g2vlm_tpu.train import trainer as jtr
from g2vlm_tpu_torch.config import tiny_test_config as port_tiny_test_config
from g2vlm_tpu_torch.models import g2vlm as tg
from g2vlm_tpu_torch.train import trainer as ttr
from g2vlm_tpu_torch.weights import build_model, state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
JCFG = tiny_test_config(visual_und=False)
CFG = port_tiny_test_config(visual_und=False)
N, H, W = 2, 56, 70  # two views, a non-square 4x5 patch grid


def _random_params(seed=0):
    """init_params with every leaf perturbed, the zero-initialized dino2llm,
    biases and register tokens included; the point heads' projections are
    scaled down so that exp(z) stays O(10)."""
    rng = np.random.default_rng(seed)
    params = jg.init_params(JCFG, jax.random.PRNGKey(seed))
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)
    for head in ("point_head", "global_point_head"):
        params[head]["proj"]["w"] = params[head]["proj"]["w"] * np.float32(0.1)
    return params


def _fresh_model(params):
    model = build_model(CFG, device="cpu", seed=None).train()
    model.load_state_dict(state_dict_from_jax(params, CFG), strict=True)
    return model


def _batch_fields(seed, sorted_layout):
    """One packed sample as numpy fields, and geo_start (None unless sorted):
    positive camera-frame depths, ~90% valid pixels, random rigid extrinsics."""
    rng = np.random.default_rng(seed)
    b = tg.SequenceBuilder(11, 12)
    hp, wp = H // 14, W // 14
    if sorted_layout:
        b.add_text([7, 23, 45] + list(rng.integers(20, 400, 5)))
        ce_idx = np.arange(b.curr - 3, b.curr)
        geo_start = b.curr
        b.add_dino_images(N, hp, wp)
    else:
        b.add_text([7, 23, 45])
        b.add_dino_images(N, hp, wp)
        b.add_text(list(rng.integers(20, 400, 5)))
        ce_idx = np.arange(b.curr - 3, b.curr)
        geo_start = None
    pre = b.build(pad_to=64)
    # camera-frame points with depths in [1.5, ...), moved to the world by each view's camera-to-world pose
    local = rng.standard_normal((N, H, W, 3)).astype(np.float32)
    local[..., 2] = np.abs(local[..., 2]) + 1.5
    extr = np.tile(np.eye(4, dtype=np.float32), (1, N, 1, 1))
    q, _ = np.linalg.qr(rng.standard_normal((N, 3, 3)))
    extr[0, :, :3, :3] = q * np.sign(np.linalg.det(q))[:, None, None]
    extr[0, :, :3, 3] = 0.3 * rng.standard_normal((N, 3))
    world = (np.einsum("nij,nhwj->nhwi", extr[0, :, :3, :3], local) + extr[0, :, None, None, :3, 3])[None]
    world = world.astype(np.float32)
    fields = dict(
        text_ids=pre.text_ids.astype(np.int32), text_indexes=pre.text_indexes.astype(np.int32),
        dino_indexes=pre.dino_indexes.astype(np.int32), vit_indexes=np.zeros((0,), np.int32),
        is_geo=pre.is_geo, position_ids=pre.position_ids,
        doc_id=pre.doc_id, fn_id=pre.fn_id, noise_id=pre.noise_id, pos=pre.pos,
        ce_indexes=ce_idx.astype(np.int32),
        ce_labels=rng.integers(0, CFG.llm.vocab_size, 3).astype(np.int32),
        ce_weights=np.asarray([1.0, 0.5, 2.0], np.float32),
        dino_images=(0.3 * rng.standard_normal((N, 3, H, W))).astype(np.float32),
        world_points=world, point_masks=rng.random((1, N, H, W)) < 0.9,
        extrinsics=extr, normal_batch_mask=np.ones((1,), bool),
    )
    return fields, geo_start


def _jbatch(fields):
    return jtr.TrainBatch(**{k: jnp.asarray(v) for k, v in fields.items()})


def _tbatch(fields):
    return ttr.TrainBatch.from_numpy(**fields)


# The L1 scale alignment returns the ratio y_i / x_i of one sampled pixel, so that pixel's
# residual scale * x_i - y_i is 0 by construction: exactly 0 in one package (subgradient 0)
# and one ulp off in the other (subgradient +-1), depending on how the compiler rounds the
# products. That one pixel of the 3*N*H*W in the point loss moves every gradient upstream of
# it by up to ~7e-4 of its largest entry at this image size, so the comparison with jax.grad
# allows 1e-3; the port's fp32 gradients are also held to its own fp64 run at 1e-5.
JAX_GRAD_REL = 1e-3


def _assert_leaf_close(got, want, name, rel=JAX_GRAD_REL, floor=1e-6):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + floor, (name, err, np.abs(want).max())


@pytest.mark.parametrize("sorted_layout", [False, True], ids=["mixed", "split"])
def test_train_forward_and_every_gradient_match_jax(sorted_layout):
    params = _random_params()
    fields, geo_start = _batch_fields(1, sorted_layout)

    def jloss(p):
        return jtr.train_forward(p, _jbatch(fields), JCFG, compute_dtype=jnp.float32, remat=False,
                                 geo_start=geo_start)

    (want, wdet), wgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jax.tree.map(jnp.asarray, params))
    want_grads = state_dict_from_jax(jax.tree.map(np.asarray, wgrads), CFG)

    model = _fresh_model(params)
    got, gdet = ttr.train_forward(model, _tbatch(fields), CFG, compute_dtype=torch.float32, remat=False,
                                  geo_start=geo_start)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    assert set(gdet) == set(wdet)
    for key in wdet:
        np.testing.assert_allclose(gdet[key].item(), float(wdet[key]), rtol=1e-4, atol=1e-6, err_msg=key)
    got.backward()
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    plain = {}
    for name, p in named.items():
        g = torch.zeros_like(p) if p.grad is None else p.grad  # DINOv2's mask token: unused, zero in JAX too
        plain[name] = g.clone()
        _assert_leaf_close(g.numpy(), want_grads[name].numpy(), name)
    assert sum(p.grad is None for p in named.values()) <= 1

    # the port's fp32 gradients against the same model and batch in fp64
    m64 = _fresh_model(params).double()
    b64 = _tbatch(fields).map(lambda x: x.double() if x.is_floating_point() else x)
    l64, _ = ttr.train_forward(m64, b64, CFG, compute_dtype=torch.float64, remat=False, geo_start=geo_start)
    l64.backward()
    for name, p in m64.named_parameters():
        if p.grad is not None:
            _assert_leaf_close(plain[name].numpy(), p.grad.numpy(), name + " vs fp64", rel=1e-5, floor=1e-6)

    # the same forward and gradients with every layer (and groups of layers) recomputed in the backward
    # (checkpointing repeats the same arithmetic: 1e-6; the view-chunked heads sum their weight
    # gradients chunk by chunk, in another order: 1e-4)
    for kw, rel in ((dict(remat=True), 1e-6), (dict(remat=True, remat_group=2, dino_remat_group=2), 1e-6),
                    (dict(remat=True, remat_group=2, remat_inner=False, head_view_chunk=1), 1e-4)):
        model.zero_grad(set_to_none=True)
        again, _ = ttr.train_forward(model, _tbatch(fields), CFG, compute_dtype=torch.float32,
                                     geo_start=geo_start, **kw)
        np.testing.assert_allclose(again.item(), got.item(), rtol=1e-6)
        again.backward()
        for name, p in named.items():
            if p.grad is not None:
                _assert_leaf_close(p.grad.numpy(), plain[name].numpy(), f"{name} {kw}", rel=rel, floor=1e-6)


def test_warmup_cosine_schedule_matches_optax():
    for args in ((0.0, 1e-4, 100, 1000), (0.0, 1e-3, 0, 10), (1e-4, 1e-3, 2, 10), (0.0, 1e-4, 5, 6)):
        want, got = optax.warmup_cosine_decay_schedule(*args), ttr.warmup_cosine_schedule(*args)
        for count in (0, 1, 2, 3, 5, 6, 9, 10, 50, 100, 500, 999, 1000, 2000):
            np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-5, atol=1e-12, err_msg=f"{args} {count}")


@pytest.mark.parametrize("factored,mu_dtype", [(False, None), (False, "bfloat16"), (True, "bfloat16"), (True, None)])
def test_optimizer_matches_optax_on_given_gradients(rng, factored, mu_dtype):
    """Three steps of clip + moments + decay + schedule on the same gradients."""
    shapes = {"big": (2, 130, 140), "mat": (128, 256), "small": (64, 200), "vec": (300,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    schedule = optax.warmup_cosine_decay_schedule(1e-3, 1e-2, 2, 10)
    jopt = jtr.make_optimizer(schedule=schedule, weight_decay=0.05, grad_clip=1.0, factored_v=factored,
                              mu_dtype=jnp.bfloat16 if mu_dtype else None)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in shapes]
    topt = ttr.Optimizer(tparams, learning_rate=ttr.warmup_cosine_schedule(1e-3, 1e-2, 2, 10), weight_decay=0.05,
                         grad_clip=1.0, factored_v=factored, mu_dtype=torch.bfloat16 if mu_dtype else None)
    for step in range(3):
        scale = (0.01, 3.0, 0.5)[step]  # below and above the clip threshold
        grads = {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(tparams, shapes):
            p.grad = torch.from_numpy(grads[k].copy())
        norm = topt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
        for p, k in zip(tparams, shapes):
            got, want = p.detach().numpy(), np.asarray(jparams[k])
            if mu_dtype:  # a last-bit difference of the fp32 sum can flip the moment's bf16 rounding (2^-9)
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=f"{k} step {step}")
                assert (np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-7).mean() > 0.999
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=f"{k} step {step}")
    assert topt.mu[0].dtype == (torch.bfloat16 if mu_dtype else torch.float32)
    assert len(topt.nu[0]) == (2 if factored else 1) and len(topt.nu[2]) == 1  # 64 rows: too small to factor


@pytest.mark.parametrize("factored", [False, True], ids=["adamw", "factored_bf16_mu"])
def test_two_train_steps_match_optax(factored):
    """Two whole steps (a batch axis of 2, clip, optimizer, EMA, und frozen)
    against g2vlm_tpu's train_step. Adam normalises each gradient entry, so an
    entry whose gradient is rounding noise (a key bias under softmax) may move
    by +-lr in either package (DINOv2's key biases and the camera head's
    translation bias are all noise: the loss does not depend on them): 99.9%
    of all entries must agree to 1e-5 of their leaf's largest, every entry to
    2 lr."""
    params = _random_params(2)
    sorted_layout = factored
    f0, geo_start = _batch_fields(3, sorted_layout)
    f1, _ = _batch_fields(4, sorted_layout)
    stacked = {k: np.stack([f0[k], f1[k]]) for k in f0}
    lr, ema_decay = 1e-4, 0.9
    kw = dict(weight_decay=0.05, freeze_und=True, factored_v=factored)

    jparams = jax.tree.map(jnp.asarray, params)
    jopt = jtr.make_optimizer(schedule=optax.warmup_cosine_decay_schedule(lr / 2, lr, 1, 10), params=jparams,
                              mu_dtype=jnp.bfloat16 if factored else None, **kw)
    jstate = jtr.init_train_state(jparams, jopt, ema=True)
    jstep = jax.jit(jtr.make_train_step(JCFG, jopt, compute_dtype=jnp.float32, ema_decay=ema_decay, donate=False,
                                        remat=False, geo_start=geo_start))
    model = _fresh_model(params)
    topt = ttr.make_optimizer(model, schedule=ttr.warmup_cosine_schedule(lr / 2, lr, 1, 10),
                              mu_dtype=torch.bfloat16 if factored else None, **kw)
    tstate = ttr.init_train_state(model, topt, ema=True)
    tstep = ttr.make_train_step(CFG, compute_dtype=torch.float32, ema_decay=ema_decay, remat=True,
                                geo_start=geo_start)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    labels = ttr.freeze_labels(model, True, False)
    jlabels = state_dict_from_jax(
        jax.tree.map(lambda l, a: np.full(a.shape, l == "frozen", np.float32),
                     jtr.freeze_labels(jparams, True, False), params), CFG)
    assert {n: l == "frozen" for n, l in labels.items()} == {n: bool(v.max() == 1) for n, v in jlabels.items()}

    jbatch = jtr.TrainBatch(**{k: jnp.asarray(v) for k, v in stacked.items()})
    tbatch = ttr.TrainBatch.from_numpy(**stacked)
    for step in range(2):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        assert set(tm) == set(jm)
        for key in set(jm) - {"grad_norm"}:
            np.testing.assert_allclose(tm[key].item(), float(jm[key]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{key} step {step}")
        # g2vlm_tpu reports the norm over every leaf, frozen ones included; the port never builds
        # a frozen leaf's gradient and reports the norm the clip uses, over the trainable leaves
        assert tm["grad_norm"].item() <= float(jm["grad_norm"]) * (1 + 1e-5)
        if step == 0 and factored:
            def mean_loss(p):
                one = lambda f: jtr.train_forward(p, _jbatch(f), JCFG, compute_dtype=jnp.float32, remat=False,
                                                  geo_start=geo_start)[0]
                return (one(f0) + one(f1)) / 2

            grads = jax.jit(jax.grad(mean_loss))(jparams)
            flags = jtr.freeze_labels(jparams, True, False)
            want_norm = optax.global_norm(jax.tree.map(lambda g, l: g * (l == "train"), grads, flags))
            np.testing.assert_allclose(tm["grad_norm"].item(), float(want_norm), rtol=1e-5)
    assert tstate.step == 2 == int(jstate.step)

    want_p = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params), CFG)
    want_e = state_dict_from_jax(jax.tree.map(np.asarray, jstate.ema_params), CFG)
    moved = within = total = 0
    for name, p in model.named_parameters():
        for got, want in ((p.detach(), want_p[name]), (tstate.ema_params[name], want_e[name])):
            got, want = got.numpy(), want.numpy()
            err = np.abs(got - want)
            assert err.max() <= 2 * lr + 1e-5 * np.abs(want).max() + 1e-7, (name, err.max())
            within += int((err <= 1e-5 * np.abs(want).max() + 1e-7).sum())
            total += err.size
        if labels[name] == "frozen":  # bitwise untouched, parameter and EMA
            assert not p.requires_grad
            assert torch.equal(p.detach(), before[name]) and torch.equal(tstate.ema_params[name], before[name])
        else:
            moved += int(not torch.equal(p.detach(), before[name]))
    assert moved > 100
    assert within / total >= 0.999, within / total
    assert "language_model.model.layers.0.mlp.up_proj.weight" in [n for n, l in labels.items() if l == "frozen"]
    assert labels["language_model.lm_head.weight"] == labels["language_model.model.embed_tokens.weight"] == "train"


def test_vit_branch_raises_until_ported():
    """The ViT branch no longer raises: on a joint pack (DINOv2 views, ViT images, padded ViT
    slots) `train_forward` gives the JAX package's loss and details. Every gradient is held
    against jax.grad in tests/test_torch_joint_train.py."""
    from test_torch_joint_train import CFG as VIT_CFG
    from test_torch_joint_train import JCFG as VIT_JCFG
    from test_torch_joint_train import _fresh_model as vit_model
    from test_torch_joint_train import _pack
    from test_torch_joint_train import _random_params as vit_params

    params = vit_params(2)
    fields, geo_start = _pack(False, seed=3)
    want, wdet = jax.jit(lambda p: jtr.train_forward(
        p, jtr.TrainBatch(**{k: jnp.asarray(v) for k, v in fields.items()}), VIT_JCFG, compute_dtype=jnp.float32,
        remat=False, geo_start=geo_start))(jax.tree.map(jnp.asarray, params))
    got, gdet = ttr.train_forward(vit_model(params), _tbatch(fields), VIT_CFG, compute_dtype=torch.float32,
                                  geo_start=geo_start)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    for key in wdet:
        np.testing.assert_allclose(gdet[key].item(), float(wdet[key]), rtol=1e-4, atol=1e-6, err_msg=key)


def test_train_torch_entry_point_runs_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "train_torch.py", "--tiny", "--synthetic", "--steps", "2", "--device", "cpu", "--log_every", "1",
         "--checkpoint_dir", str(tmp_path / "ckpts")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "step 1 " in proc.stderr and "done" in proc.stderr


def test_train_torch_model_path_matches_in_memory(tmp_path):
    """--model_path: the fp32 masters come from the checkpoint (and the
    vocabulary from its files); with the weights of the in-memory run's
    seeded init, step 0 logs the same metrics."""
    from torch_checkpoint import write_checkpoint

    with_vit = port_tiny_test_config()  # what the checkpoint's config files describe
    sd = build_model(with_vit, device="cpu", seed=0).state_dict()
    in_memory = build_model(CFG, device="cpu", seed=0).state_dict()
    assert all(torch.equal(sd[k], v) for k, v in in_memory.items())  # the ViT draws come last
    ck = write_checkpoint(tmp_path / "ckpt", sd, with_vit, vocab=True)
    step0 = []
    for extra in ([], ["--model_path", str(ck)]):
        proc = subprocess.run(
            [sys.executable, "train_torch.py", "--tiny", "--synthetic", "--steps", "1", "--device", "cpu",
             "--log_every", "1", "--checkpoint_dir", str(tmp_path / "out"), *extra], cwd=REPO, capture_output=True,
            text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        line = next(line for line in proc.stderr.splitlines() if "step 0 " in line)
        step0.append([w for w in line[line.index("step 0 "):].split() if not w.endswith("ms/step")])
    assert "loss=" in " ".join(step0[0]) and step0[0] == step0[1]


def _step0_metrics(stderr):
    line = next(line for line in stderr.splitlines() if "step 0 " in line)
    words = line[line.index("step 0 ") + len("step 0 "):].split()
    return {k: float(v) for k, v in (w.split("=") for w in words if "=" in w)}


def test_train_torch_model_path_matches_jax_train_py(tmp_path):
    """`train_torch.py --model_path` against `train.py --model_path` on one
    checkpoint directory (perturbed weights, the checkpoint's config with the
    ViT tower, the bpe_fixture vocabulary): both trainers draw the same
    synthetic pack from the seed, and every step-0 metric agrees within 1e-4
    of its magnitude plus the 1e-4 of the printed rounding."""
    import os

    from torch_checkpoint import random_state_dict, write_checkpoint

    ck = write_checkpoint(tmp_path / "ckpt", random_state_dict(), vocab=True)
    common = ["--tiny", "--synthetic", "--steps", "1", "--log_every", "1", "--model_path", str(ck)]
    runs = {}
    for script, extra, env in (
        ("train.py", ["--checkpoint_dir", str(tmp_path / "out")], dict(os.environ, JAX_PLATFORMS="cpu")),
        ("train_torch.py", ["--device", "cpu", "--checkpoint_dir", str(tmp_path / "out_torch")], None),
    ):
        proc = subprocess.run([sys.executable, script, *common, *extra], cwd=REPO, capture_output=True, text=True,
                              timeout=300, env=env)
        assert proc.returncode == 0, (script, proc.stderr[-2000:])
        runs[script] = _step0_metrics(proc.stderr)
    want, got = runs["train.py"], runs["train_torch.py"]
    assert {"loss", "ce", "dl", "grad_norm", "local_pts_loss"} <= set(want) and set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * abs(v) + 1e-4, (k, got[k], v)


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--train_conf"], ["--bootstrap_moe"], []])
def test_train_torch_flags_that_wait_for_a_module_raise(flags):
    """No flag of train.py waits for a module any more: --dp (with --tp and
    --sequence_parallel, the multi-GPU mesh; tests/test_torch_parallel.py
    runs them), --train_conf and --bootstrap_moe parse and set what train.py
    sets (tests/test_torch_conf_head.py and tests/test_torch_dense_moe.py run
    them against train.py); without data, parse_args raises."""
    sys.path.insert(0, str(REPO))
    try:
        import train_torch
    finally:
        sys.path.pop(0)
    if not flags:  # neither --synthetic nor --data_config: no data
        with pytest.raises(ValueError, match="--data_config.*--synthetic"):
            train_torch.parse_args([])
        return
    args = train_torch.parse_args(["--synthetic"] + flags)
    if flags[0] == "--dp":
        assert args.dp == 2 and args.tp == 1 and args.sequence_parallel is False
        return
    assert getattr(args, flags[0][2:]) is True and args.segformer_pth is None
    assert not hasattr(train_torch, "_NOT_PORTED")
