"""PIL's fixed-point resampler in the port (g2vlm_tpu_torch/ops/resample.py) on the CPU: the
plain version bitwise equals Pillow's `Image.resize` for LANCZOS and BICUBIC at chat-short's
shapes and over a seeded sweep of sizes; and `G2VLMPipeline.chat_prefill`'s default path, which
runs it, hands the towers bitwise the inputs of the host PIL path (`load_views` +
`resnet_normalize`, `preprocess_vit_image` + `pack_views`, cast to the model's dtype).

The kernels beside the plain version are held to it on the card by
tests/test_torch_cuda_resample.py."""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from g2vlm_tpu_torch.config import tiny_test_config
from g2vlm_tpu_torch.data.images import load_views, resnet_normalize
from g2vlm_tpu_torch.data.vit_preprocess import preprocess_vit_image
from g2vlm_tpu_torch.inference import pipeline as pipeline_mod
from g2vlm_tpu_torch.models import qwen_vit
from g2vlm_tpu_torch.ops import resample
from g2vlm_tpu_torch.weights import build_model

_TINY = tiny_test_config()
CFG = dataclasses.replace(_TINY, llm=dataclasses.replace(_TINY.llm, vocab_size=5120))
TOKEN_IDS = dict(bos_token_id=7, eos_token_id=8, start_of_image=11, end_of_image=12)
_PIL = {resample.LANCZOS: Image.Resampling.LANCZOS, resample.BICUBIC: Image.Resampling.BICUBIC}


def _sweep():
    """Seeded (in hw, out hw, filter) cases: up and down, odd sizes, one axis alone, extreme ratios."""
    rng = np.random.default_rng(20)
    cases = [((33, 47), (33, 20), resample.LANCZOS), ((33, 47), (61, 47), resample.BICUBIC),
             ((7, 300), (5, 3), resample.LANCZOS), ((2, 3), (41, 29), resample.BICUBIC)]
    for _ in range(12):
        h0, w0, h1, w1 = (int(v) for v in rng.integers(20, 320, 4))
        cases.append(((h0, w0), (h1, w1), (resample.LANCZOS, resample.BICUBIC)[int(rng.integers(2))]))
    return cases


CHAT_SHAPES = [((480, 640), (392, 518), resample.LANCZOS), ((480, 640), (768, 768), resample.BICUBIC),
               ((768, 768), (756, 756), resample.BICUBIC)]


@pytest.mark.parametrize("in_hw,out_hw,filt", CHAT_SHAPES + _sweep())
def test_plain_resize_equals_pillow(in_hw, out_hw, filt):
    frames = np.random.default_rng(sum(in_hw) * 7 + sum(out_hw)).integers(0, 256, (2, *in_hw, 3), dtype=np.uint8)
    got = resample.resize(torch.from_numpy(frames), out_hw, filt).numpy()
    ref = np.stack([np.asarray(Image.fromarray(f).resize(out_hw[::-1], _PIL[filt])) for f in frames])
    np.testing.assert_array_equal(got, ref)


def test_tables_are_cached_and_an_unchanged_axis_is_the_identity():
    a = resample.table(480, 392, resample.LANCZOS, "cpu")
    assert resample.table(480, 392, resample.LANCZOS, "cpu") is a and a.dtype == torch.int32
    assert a.shape == (392, 2 + 2 * 4 + 1)  # support 3 x 480 / 392 -> ksize 9
    # every row's taps sum to 1.0 within the rounding of its taps, and none past its count
    n = a[:, 1]
    assert int(n.max()) <= a.shape[1] - 2 and (a[:, 2:].sum(1) - (1 << 22)).abs().max() <= n.max()
    eye = resample.table(9, 9, resample.BICUBIC, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 9, 4, 3), dtype=np.uint8))
    assert torch.equal(resample.resample_pass_plain(x, eye, axis=1), x)


def _parent_inputs(images, new_width, dtype):
    """The host PIL path of chat_prefill before the resample kernels: (views, patches, coords, seg, grids)."""
    views = torch.as_tensor(resnet_normalize(load_views(images, new_width=new_width))).to(dtype)
    vit = [preprocess_vit_image(im) for im in images]
    n_pat = sum(int(np.prod(g)) for _, g in vit)
    pats, coords, seg, _ = qwen_vit.pack_views([{"patches": p, "grid_thw": g} for p, g in vit],
                                               pad_to=-(-n_pat // 8) * 8)
    return views, torch.as_tensor(pats).to(dtype), coords, seg, [g for _, g in vit]


@pytest.fixture(scope="module")
def pipe():
    return pipeline_mod.G2VLMPipeline(build_model(CFG, device="cpu", dtype=torch.bfloat16, seed=0), CFG,
                                      new_token_ids=dict(TOKEN_IDS), seq_pad_multiple=32)


def _frames(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in shapes]


@pytest.mark.parametrize("images", [
    pytest.param([(480, 640)] * n, id=f"{n}x480x640") for n in (1, 2, 3, 4)] + [
    pytest.param([(120, 160), (96, 200), (96, 200), (120, 160), (61, 77)], id="mixed")])
def test_chat_prefill_inputs_equal_the_pil_path(pipe, monkeypatch, images):
    frames = _frames(images, seed=len(images))
    if len(images) == 5:  # an RGB and a grey PIL image among the arrays
        frames[1] = Image.fromarray(frames[1])
        frames[4] = Image.fromarray(frames[4][..., 0])
    seen = {}

    def capture(model, prefill, normed, cfg, **kw):
        seen.update(kw, normed=normed, prefill=prefill)
        return None, None

    monkeypatch.setattr(pipeline_mod, "prefill_hidden", capture)
    pipe.chat_prefill(frames, "where is the chair?", new_width=518 if len(images) < 5 else 56)
    views, pats, coords, seg, grids = _parent_inputs(frames, 518 if len(images) < 5 else 56, torch.bfloat16)
    for got, ref in ((seen["normed"], views), (seen["vit_patches"], pats)):
        assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    for got, ref in ((seen["vit_coords"], coords), (seen["vit_seg"], seg)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    ref_prefill = pipe.build_chat_prefill(len(frames), views.shape[2] // 14, views.shape[3] // 14, grids,
                                          "where is the chair?")
    for got, ref in zip(seen["prefill"], ref_prefill):
        np.testing.assert_array_equal(got, ref)


def test_chat_prefill_refuses_what_is_no_rgb_image(pipe):
    with pytest.raises(ValueError, match="uint8"):
        pipe.chat_prefill([np.zeros((40, 60, 3), np.float32)], "why?")
    with pytest.raises(ValueError, match="uint8"):
        pipe.chat_prefill([np.zeros((40, 60), np.uint8)], "why?")


def test_wrappers_refuse_frames_they_do_not_take():
    with pytest.raises(ValueError, match="uint8"):
        resample.resample_pass(torch.zeros((1, 4, 4, 3), dtype=torch.float32), 2, resample.BICUBIC, axis=2)
    with pytest.raises(ValueError, match="out of shape"):
        resample.resample_views(torch.zeros((1, 4, 4, 3), dtype=torch.uint8), (2, 2), resample.BICUBIC,
                                (0, 0, 0), (1, 1, 1), torch.empty((1, 3, 2, 3)))
    with pytest.raises(ValueError, match="multiple of 28"):
        resample.resample_patch_rows(torch.zeros((1, 4, 4, 3), dtype=torch.uint8), (14, 14), resample.BICUBIC,
                                     (0, 0, 0), (1, 1, 1), torch.empty((1, 1176)))
