"""The conf-head training stage of the port (`train_conf_pi3`, `--train_conf`)
against g2vlm_tpu on the CPU in fp32 at tiny widths: the conf decoder and
head's output beside the other heads (also one view at a time), the sky mask
the trainer predicts in-program with the frozen SegFormer, a `train_forward`
with the conf loss (`local_conf_loss` and every detail, every gradient),
the freeze labels with the SegFormer, a whole `train_step` that leaves the
SegFormer and its EMA bitwise alone, `load_checkpoint` with a config that
trains the conf head, and `train_torch.py --train_conf` (with the SegFormer
from the checkpoint or from `--segformer_pth`) against `train.py`.

Tolerances: single modules 1e-4 of max|ref|, end to end 1e-3, the loss and
its details 1e-4 relative, gradients 1e-3 of each leaf's largest entry (the
L1 alignment's pivot pixel, tests/test_torch_trainer.py) and 1e-5 against
the port's own fp64 run."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vlm_tpu.models import g2vlm as jg
from g2vlm_tpu.models import segformer as jseg
from g2vlm_tpu.train import trainer as jtr
from g2vlm_tpu_torch import weights as tw
from g2vlm_tpu_torch.models import g2vlm as tg
from g2vlm_tpu_torch.models import segformer as tseg
from g2vlm_tpu_torch.train import trainer as ttr
from torch_alternates import assert_every_gradient_matches, batch_fields, configs, random_params, two_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
JCFG, CFG = configs(train_conf_pi3=True)
# (parameter seed, batch seed): the pivot pixel agrees at these (tests/test_torch_dense_moe.py GRAD_CASES)
SEEDS = (0, 1)


def _params(seed=0):
    """Perturbed parameters with the conf decoder and head and a SegFormer whose sky class is
    raised, so that about half of the pixels are sky."""
    params = random_params(JCFG, seed)
    params["segformer"]["head"]["pred"]["b"][2] += 4.5
    params["segformer"]["head"]["fuse_bn"]["var"] = np.abs(params["segformer"]["head"]["fuse_bn"]["var"]) + 0.5
    return params


def _model(params, dtype=torch.float32):
    model = tw.build_model(CFG, device="cpu", seed=None).train()
    model.load_state_dict(tw.state_dict_from_jax(params, CFG), strict=True)
    return model.to(dtype)


@pytest.fixture(scope="module")
def params():
    return _params(SEEDS[0])


def test_keys_are_the_reference_key_space(params):
    sd = tw.state_dict_from_jax(params, CFG)
    model = _model(params)
    assert set(sd) == set(model.state_dict())
    for key in ("conf_decoder.blocks.4.attn.qkv.weight", "conf_head.proj.weight",
                "Pi3Loss.point_loss.segformer.backbone.block1.0.attn.sr.weight",
                "Pi3Loss.point_loss.segformer.decode_head.linear_fuse.bn.running_var"):
        assert key in sd, key
    assert model.conf_head.proj.weight.shape == (14 * 14, CFG.pi3.point_out_dim)  # one channel per pixel
    back = jg.params_from_torch(sd, JCFG)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_conf_decoder_and_head_match_jax(params, rng):
    """pi3_predict with the conf branch (the JAX package runs the point, camera and conf decoders as
    one K-stacked scan; the port runs three decoders), and one view at a time."""
    hidden = (0.5 * rng.standard_normal((2, 20, CFG.llm.hidden_size))).astype(np.float32)
    want = jg.pi3_predict(jax.tree.map(jnp.asarray, params), jnp.asarray(hidden), (56, 70), JCFG)
    model = _model(params)
    with torch.no_grad():
        got = tg.pi3_predict(model, torch.from_numpy(hidden), (56, 70), CFG)
        chunked = tg.pi3_predict(model, torch.from_numpy(hidden), (56, 70), CFG, view_chunk=1)
    assert set(got) == set(want) and got["conf"].shape == (2, 56, 70, 1)
    for key, val in got.items():
        ref = np.asarray(want[key])
        tol = 1e-3 if key == "points" else 1e-4  # points: pose @ exp(z)-scaled local points
        assert np.abs(val.numpy() - ref).max() <= tol * np.abs(ref).max(), key
        torch.testing.assert_close(chunked[key], val, rtol=1e-5, atol=1e-5)


def test_in_program_sky_mask_matches_the_jax_trainer(params):
    """The JAX trainer's sky mask is `predict_sky_mask` of the frozen SegFormer on the batch's
    views; the port's trainer computes it from the same module. Equal off near-ties."""
    fields, _ = batch_fields(CFG, SEEDS[1])
    imgs = fields["dino_images"]
    logits = np.asarray(jseg.seg_logits(params["segformer"], imgs, jseg.SegformerConfig()))
    want = np.asarray(jseg.predict_sky_mask(params["segformer"], imgs))
    with torch.no_grad():
        got = tseg.predict_sky_mask(_model(params).segformer, torch.from_numpy(imgs)).numpy()
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    np.testing.assert_array_equal(got[clear], want[clear])
    assert 0.05 < want.mean() < 0.95 and clear.mean() > 0.99


def test_train_forward_with_the_conf_loss_matches_jax(params):
    fields, geo_start = batch_fields(CFG, SEEDS[1])

    def jloss(p):
        return jtr.train_forward(p, jtr.TrainBatch(**{k: jnp.asarray(v) for k, v in fields.items()}), JCFG,
                                 compute_dtype=jnp.float32, remat=False, geo_start=geo_start)

    (want, wdet), wgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jax.tree.map(jnp.asarray, params))
    want_grads = tw.state_dict_from_jax(jax.tree.map(np.asarray, wgrads), CFG)
    model = _model(params)
    ttr.apply_freeze(model)
    got, gdet = ttr.train_forward(model, ttr.TrainBatch.from_numpy(**fields), CFG, compute_dtype=torch.float32,
                                  remat=True, geo_start=geo_start)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    assert "local_conf_loss" in gdet and set(gdet) == set(wdet)
    for key in wdet:
        np.testing.assert_allclose(gdet[key].item(), float(wdet[key]), rtol=1e-4, atol=1e-6, err_msg=key)
    got.backward()
    moved = assert_every_gradient_matches(model, want_grads)
    assert {"conf_decoder.blocks.0.attn.qkv.weight", "conf_head.proj.weight"} <= moved
    assert not any(n.startswith("Pi3Loss.") for n in moved)  # frozen: no gradient is built
    m64 = _model(params, torch.float64)
    ttr.apply_freeze(m64)
    b64 = ttr.TrainBatch.from_numpy(**fields).map(lambda x: x.double() if x.is_floating_point() else x)
    ttr.train_forward(m64, b64, CFG, compute_dtype=torch.float64, remat=False, geo_start=geo_start)[0].backward()
    assert_every_gradient_matches(model, {n: torch.zeros_like(p).float() if p.grad is None else p.grad.float()
                                          for n, p in m64.named_parameters()}, rel=1e-5)
    # sky masks passed in are used as they are: all-sky moves the conf loss
    sky = torch.ones((1,) + fields["dino_images"].shape[:1] + fields["dino_images"].shape[2:], dtype=torch.bool)
    with torch.no_grad():
        _, det = ttr.train_forward(model, ttr.TrainBatch.from_numpy(**fields, sky_masks=sky.numpy()), CFG,
                                   compute_dtype=torch.float32, remat=False, geo_start=geo_start)
    assert abs(det["local_conf_loss"].item() - gdet["local_conf_loss"].item()) > 1e-3


@pytest.mark.parametrize("freeze_und,freeze_recon", [(False, False), (True, False), (False, True), (True, True)])
def test_freeze_labels_with_the_segformer_match_jax(params, freeze_und, freeze_recon):
    labels = jtr.freeze_labels(params, freeze_und, freeze_recon)
    as_arrays = jax.tree.map(lambda lab, p: np.full(np.shape(p), lab == "train", np.float32), labels, params)
    want = tw.state_dict_from_jax(as_arrays, CFG)
    model = tw.build_model(CFG, device="cpu", seed=0)
    got = ttr.apply_freeze(model, freeze_und, freeze_recon)
    assert set(got) == {n for n, _ in model.named_parameters()} and set(got) <= set(want)
    for name in got:
        assert got[name] == ("train" if want[name].max() == 1 else "frozen"), name
    assert all(got[n] == "frozen" for n in got if n.startswith("Pi3Loss."))
    assert got["conf_head.proj.weight"] == ("frozen" if freeze_recon else "train")


def test_train_step_leaves_the_segformer_and_its_ema_alone(params):
    fields, geo_start = batch_fields(CFG, SEEDS[1])
    model = _model(params)
    opt = ttr.make_optimizer(model, learning_rate=1e-3, freeze_und=True)
    state = ttr.init_train_state(model, opt, ema=True)
    seg = {n: t.clone() for n, t in model.segformer.state_dict().items()}
    conf = model.conf_head.proj.weight.detach().clone()
    step = ttr.make_train_step(CFG, compute_dtype=torch.float32, ema_decay=0.9, geo_start=geo_start)
    batch = ttr.TrainBatch.from_numpy(**fields).map(lambda x: x[None])
    for _ in range(2):
        state, metrics = step(state, batch)
        assert np.isfinite(metrics["local_conf_loss"].item())
    for n, t in model.segformer.state_dict().items():
        assert torch.equal(t, seg[n]), n
        key = "Pi3Loss.point_loss.segformer." + n
        assert key not in state.ema_params or torch.equal(state.ema_params[key], seg[n]), n
    assert not torch.equal(model.conf_head.proj.weight, conf)


def test_load_checkpoint_fills_what_a_conf_config_lacks_and_audits_as_jax(tmp_path, params):
    """A checkpoint without the conf pieces loads into a conf config: the conf decoder and head
    and the SegFormer are drawn from the seed; the audit of both packages calls nothing
    missing. With them, they are loaded."""
    from g2vlm_tpu import weights as jw
    from torch_checkpoint import write_checkpoint

    full = tw.state_dict_from_jax(params, CFG)
    plain = {k: v for k, v in full.items() if not k.startswith(("conf_", "Pi3Loss."))}
    for name, sd in (("plain", plain), ("full", full)):
        ck = write_checkpoint(tmp_path / name, sd, CFG)
        model, _ = tw.load_checkpoint(str(ck), device="cpu", dtype=torch.float32, cfg=CFG, seed=7)
        assert tw.audit_keys(sd, CFG) == jw.audit_keys(sd, JCFG) == {"unknown": [], "missing": []}
        got = model.state_dict()
        for k, v in sd.items():
            assert torch.equal(got[k], v), k
        if name == "plain":
            assert tw.absent_optional(sd, CFG) == ("conf_decoder.", "conf_head.", tw.SEGFORMER_PREFIX)
            assert got["Pi3Loss.point_loss.segformer.decode_head.linear_fuse.bn.running_var"].eq(1).all()
            assert got["conf_head.proj.weight"].std() > 0
        else:
            assert tw.absent_optional(sd, CFG) == ()
    # a config that does not train the conf head ignores the loss module's keys, as the JAX audit does
    no_conf = dataclasses.replace(CFG, train_conf_pi3=False)
    seg_only = {**plain, **{k: v for k, v in full.items() if k.startswith("Pi3Loss.")}}
    assert tw.audit_keys(seg_only, no_conf) == jw.audit_keys(seg_only, dataclasses.replace(JCFG, train_conf_pi3=False))


def _step0_metrics(stderr):
    line = next(line for line in stderr.splitlines() if "step 0 " in line)
    words = line[line.index("step 0 ") + len("step 0 "):].split()
    return {k: float(v) for k, v in (w.split("=") for w in words if "=" in w)}


@pytest.mark.parametrize("segformer_from", ["checkpoint", "pth"])
def test_train_torch_train_conf_matches_train_py(tmp_path, segformer_from):
    """`--model_path <checkpoint> --train_conf` in both trainers, the conf decoder and head in the
    checkpoint and the SegFormer from its `Pi3Loss.*` keys or from `--segformer_pth`: every step-0
    metric (local_conf_loss among them) within 1e-4 of its magnitude plus the 1e-4 of the printed
    rounding."""
    from torch_checkpoint import CKPT_CFG, write_checkpoint

    jcfg, cfg = configs(visual_und=True, vocab_size=5120, train_conf_pi3=True)
    assert cfg.llm == CKPT_CFG.llm
    p = random_params(jcfg, seed=4)
    p["segformer"]["head"]["pred"]["b"][2] += 4.5
    sd = tw.state_dict_from_jax(p, cfg)
    extra = []
    if segformer_from == "pth":
        seg = {k[len(tw.SEGFORMER_PREFIX):]: sd.pop(k) for k in list(sd) if k.startswith(tw.SEGFORMER_PREFIX)}
        torch.save({"state_dict": seg}, tmp_path / "seg.pth")
        extra = ["--segformer_pth", str(tmp_path / "seg.pth")]
    ck = write_checkpoint(tmp_path / "ckpt", sd, cfg, vocab=True)
    common = ["--tiny", "--synthetic", "--steps", "1", "--log_every", "1", "--model_path", str(ck), "--train_conf",
              *extra]
    runs = {}
    for script, out, env in (
        ("train.py", ["--checkpoint_dir", str(tmp_path / "out")], dict(os.environ, JAX_PLATFORMS="cpu")),
        ("train_torch.py", ["--device", "cpu", "--checkpoint_dir", str(tmp_path / "out_torch")], None),
    ):
        proc = subprocess.run([sys.executable, script, *common, *out], cwd=REPO, capture_output=True, text=True,
                              timeout=300, env=env)
        assert proc.returncode == 0, (script, proc.stderr[-2000:])
        assert "RANDOM weights" not in proc.stderr
        runs[script] = _step0_metrics(proc.stderr)
    want, got = runs["train.py"], runs["train_torch.py"]
    assert {"loss", "ce", "dl", "grad_norm", "local_conf_loss"} <= set(want) and set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * abs(v) + 1e-4, (k, got[k], v)


def test_train_torch_train_conf_warns_when_the_segformer_is_random(tmp_path):
    sys.path.insert(0, str(REPO))
    try:
        import train_torch
    finally:
        sys.path.pop(0)
    args = train_torch.parse_args(["--tiny", "--synthetic", "--steps", "1", "--device", "cpu", "--train_conf",
                                   "--checkpoint_dir", str(tmp_path / "ck")])
    assert args.train_conf and args.segformer_pth is None
    proc = subprocess.run([sys.executable, "train_torch.py", "--tiny", "--synthetic", "--steps", "1", "--device", "cpu",
                           "--log_every", "1", "--train_conf", "--checkpoint_dir", str(tmp_path / "ck")], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "RANDOM weights" in proc.stderr and "local_conf_loss=" in proc.stderr
