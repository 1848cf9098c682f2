"""The port's SegFormer (mit_b0 and its all-MLP head, the frozen sky
segmenter of the conf head) against g2vlm_tpu's on the CPU in fp32:
`seg_logits` on 64x96 images within 1e-4 of max|ref| (a single module),
`predict_sky_mask` equal on every pixel whose two largest logits are more
than 1e-4 apart, the state-dict round trip, and `load_segformer_pth` against
the JAX loader on an mmseg-layout `.pth` that the test writes with
`torch.save`."""

import jax
import numpy as np
import pytest
import torch

from g2vlm_tpu import weights as jw
from g2vlm_tpu.models import segformer as jseg
from g2vlm_tpu_torch import weights as tw
from g2vlm_tpu_torch.config import SegformerConfig
from g2vlm_tpu_torch.models import segformer as tseg
from torch_alternates import perturbed, two_threads  # noqa: F401

H, W = 64, 96
TIE = 1e-4


def _params(seed=0):
    """Perturbed random SegFormer parameters; the sky class's bias raised so
    that a good share of the pixels come out sky."""
    params = perturbed(jseg.init_params(jax.random.PRNGKey(seed)), seed)
    params["head"]["pred"]["b"][2] += 4.5
    params["head"]["fuse_bn"]["var"] = np.abs(params["head"]["fuse_bn"]["var"]) + 0.5
    return params


def _model(params):
    sd = {}
    tw._segformer(sd, params, "")
    model = tseg.Segformer(SegformerConfig())
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def both():
    params = _params()
    return params, _model(params)


def _images(seed):
    return (np.random.default_rng(seed).standard_normal((2, 3, H, W)) * 0.8).astype(np.float32)


def test_seg_logits_match_jax(both):
    params, model = both
    imgs = _images(1)
    want = np.asarray(jseg.seg_logits(params, imgs, jseg.SegformerConfig()))
    with torch.no_grad():
        got = tseg.seg_logits(model, torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape == (2, 150, H, W)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_sky_mask_matches_jax_off_near_ties(both):
    params, model = both
    imgs = _images(2)
    logits = np.asarray(jseg.seg_logits(params, imgs, jseg.SegformerConfig()))
    want = np.asarray(jseg.predict_sky_mask(params, imgs))
    with torch.no_grad():
        got = tseg.predict_sky_mask(model, torch.from_numpy(imgs)).numpy()
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > TIE
    assert got.dtype == want.dtype == bool and got.shape == (2, H, W)
    np.testing.assert_array_equal(got[clear], want[clear])
    assert 0.05 < want.mean() < 0.95 and clear.mean() > 0.99


def test_state_dict_round_trip_is_exact(both):
    params, model = both
    back = jseg.params_from_torch(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_load_segformer_pth_matches_jax(both, tmp_path):
    """An mmseg checkpoint: {'meta': ..., 'state_dict': backbone.* / decode_head.*}, with the
    BatchNorm's step counter that neither loader consumes."""
    params, model = both
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["decode_head.linear_fuse.bn.num_batches_tracked"] = torch.tensor(160000)
    path = tmp_path / "segformer.b0.pth"
    torch.save({"meta": {"iter": 160000}, "state_dict": sd}, path)
    got = tw.load_segformer_pth(str(path))
    want = jw.load_segformer_pth(str(path))
    assert set(got) == set(model.state_dict())
    for a, b in zip(jax.tree.leaves(jseg.params_from_torch(got)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    again = tseg.Segformer(SegformerConfig())
    again.load_state_dict(got, strict=True)
    imgs = torch.from_numpy(_images(3))
    with torch.no_grad():
        assert torch.equal(tseg.seg_logits(again, imgs), tseg.seg_logits(model, imgs))
    del sd["backbone.norm4.weight"]
    torch.save(sd, path)  # a bare state dict, one key short
    with pytest.raises(KeyError, match="backbone.norm4.weight"):
        tw.load_segformer_pth(str(path))
