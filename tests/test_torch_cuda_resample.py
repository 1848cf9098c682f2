"""The resample kernels (g2vlm_tpu_torch/csrc/image_resample.cu: `resample_pass`,
`resample_views`, `resample_patch_rows`) on the card: bitwise their plain versions and Pillow
at chat-short's shapes (480x640 frames; LANCZOS to 392x518, bicubic to 768x768 then 756x756),
in bf16, fp16 and fp32; 6 launches for a request of uniform frames; and `pipe.chat`'s served
ids on a cut-depth model equal to those of the host PIL path it replaced.

Needs an NVIDIA GPU with nvcc; imports no jax. Run it on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_resample.py -q
"""

import numpy as np
import pytest
import torch
from PIL import Image

from g2vlm_tpu_torch.config import G2VLMConfig, cut_depth_config
from g2vlm_tpu_torch.data.images import RESNET_MEAN, RESNET_STD, load_views, resnet_normalize
from g2vlm_tpu_torch.data.vit_preprocess import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD, preprocess_vit_image
from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
from g2vlm_tpu_torch.models import qwen_vit
from g2vlm_tpu_torch.ops import flash_attention as fa
from g2vlm_tpu_torch.ops import resample
from g2vlm_tpu_torch.weights import build_model

pytestmark = pytest.mark.cuda

_PIL = {resample.LANCZOS: Image.Resampling.LANCZOS, resample.BICUBIC: Image.Resampling.BICUBIC}


@pytest.fixture(scope="module")
def frames():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    fa.load_library()
    rng = np.random.default_rng(0)
    low = rng.integers(0, 256, (4, 60, 80, 3), dtype=np.uint8)  # chat-short's pool: 8x8 blocks
    blocky = np.repeat(np.repeat(low, 8, axis=1), 8, axis=2)
    noise = rng.integers(0, 256, (4, 480, 640, 3), dtype=np.uint8)
    return np.concatenate([blocky, noise])


def _pil(frames, hw, filt):
    return np.stack([np.asarray(Image.fromarray(f).resize(hw[::-1], _PIL[filt])) for f in frames])


@pytest.mark.parametrize("in_hw,out_hw,filt", [
    ((480, 640), (392, 518), resample.LANCZOS), ((480, 640), (768, 768), resample.BICUBIC),
    ((768, 768), (756, 756), resample.BICUBIC), ((480, 640), (480, 518), resample.LANCZOS),
    ((480, 640), (61, 640), resample.BICUBIC), ((37, 53), (301, 97), resample.LANCZOS)])
def test_resample_pass_equals_plain_and_pillow(frames, in_hw, out_hw, filt):
    x = np.ascontiguousarray(frames[:, :in_hw[0], :in_hw[1]]) if in_hw[0] <= 480 else _pil(frames, in_hw, filt)
    got = resample.resize(torch.from_numpy(x).cuda(), out_hw, filt)
    torch.cuda.synchronize()
    plain = resample.resize(torch.from_numpy(x), out_hw, filt)
    assert torch.equal(got.cpu(), plain)
    np.testing.assert_array_equal(got.cpu().numpy(), _pil(x, out_hw, filt))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_fused_epilogues_equal_plain_and_the_host_path(frames, dtype):
    x = torch.from_numpy(frames)
    views = resample.resample_views(x.cuda(), (392, 518), resample.LANCZOS, RESNET_MEAN, RESNET_STD,
                                    torch.empty((8, 3, 392, 518), dtype=dtype, device="cuda"))
    stage = resample.resize(x.cuda(), (768, 768), resample.BICUBIC)
    rows = resample.resample_patch_rows(stage, (756, 756), resample.BICUBIC, OPENAI_CLIP_MEAN, OPENAI_CLIP_STD,
                                        torch.full((8 * 2916 + 4, 1176), 7.0, dtype=dtype, device="cuda"))
    torch.cuda.synchronize()
    plain_views = resample.resample_views(x, (392, 518), resample.LANCZOS, RESNET_MEAN, RESNET_STD,
                                          torch.empty((8, 3, 392, 518), dtype=dtype))
    plain_rows = resample.resample_patch_rows(resample.resize(x, (768, 768), resample.BICUBIC), (756, 756),
                                              resample.BICUBIC, OPENAI_CLIP_MEAN, OPENAI_CLIP_STD,
                                              torch.full((8 * 2916 + 4, 1176), 7.0, dtype=dtype))
    host_views = torch.as_tensor(resnet_normalize(load_views(list(frames), new_width=518))).to(dtype)
    host_rows = torch.as_tensor(qwen_vit.pack_views(
        [dict(zip(("patches", "grid_thw"), preprocess_vit_image(f))) for f in frames], pad_to=8 * 2916 + 4)[0]).to(dtype)
    for got, want in ((views, plain_views), (views, host_views), (rows, plain_rows), (rows, host_rows)):
        assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got.cpu(), want)


def _pil_path(pipe):
    """pipe._chat_images as the host PIL path computed it: load_views + resnet_normalize,
    preprocess_vit_image + pack_views, then the upload and the cast."""
    def chat_images(flat, shapes, hw, grid, rows):
        host = flat.cpu().numpy()
        imgs, off = [], 0
        for s in shapes:
            imgs.append(host[off:off + int(np.prod(s))].reshape(s))
            off += int(np.prod(s))
        views = resnet_normalize(load_views(imgs, new_width=hw[1]))
        pats = qwen_vit.pack_views([dict(zip(("patches", "grid_thw"), preprocess_vit_image(im))) for im in imgs],
                                   pad_to=rows)[0]
        dt = pipe.model.dtype
        return torch.as_tensor(views).to("cuda", dt), torch.as_tensor(pats).to("cuda", dt)

    return chat_images


def test_chat_launches_six_kernels_and_serves_the_pil_paths_ids(frames, monkeypatch):
    cfg = cut_depth_config(G2VLMConfig(), 2)
    pipe = G2VLMPipeline(build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0), cfg,
                         new_token_ids=dict(bos_token_id=7, eos_token_id=8, start_of_image=11, end_of_image=12))
    question = "how far is the lamp from the door on the left of the second view"
    served = {}
    for n in (1, 2, 3, 4):
        resample.reset_launch_counts()
        served[n] = pipe.chat(list(frames[:n]), question, max_new_tokens=12)
        assert resample.launch_counts == {"resample_pass": 4, "resample_views": 1, "resample_patch_rows": 1}
    monkeypatch.setattr(pipe, "_chat_images", _pil_path(pipe))
    resample.reset_launch_counts()
    for n in (1, 2, 3, 4):
        assert pipe.chat(list(frames[:n]), question, max_new_tokens=12) == served[n]
    assert sum(resample.launch_counts.values()) == 0
