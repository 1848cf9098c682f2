"""The chat slice of the port (g2vlm_tpu_torch) against g2vlm_tpu on the CPU in
fp32 at tiny widths: the mixed prefill with ViT rows in SPLIT and MIXED
routing, `G2VLMPipeline.chat` from images and from uint8 frames preprocessed
on the device, `chat_continue`, the device ViT preprocess, the host-side
copies the port keeps of the JAX package's numpy modules, and the entry
points' device rule."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import infer_chat_torch
from g2vlm_tpu.config import tiny_test_config
from g2vlm_tpu.data import device_preprocess as jdp
from g2vlm_tpu.data import tokenizer as jtok
from g2vlm_tpu.data import vit_preprocess as jvp
from g2vlm_tpu.inference.pipeline import G2VLMPipeline as JaxPipeline
from g2vlm_tpu.models import g2vlm as jg
from g2vlm_tpu.utils import image as jimage
from g2vlm_tpu_torch.data import device_preprocess as tdp
from g2vlm_tpu_torch.data import tokenizer as ttok
from g2vlm_tpu_torch.data import vit_preprocess as tvp
from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
from g2vlm_tpu_torch.models import g2vlm as tg
from g2vlm_tpu_torch.models import qwen_vit as tvit
from g2vlm_tpu_torch.ops import flash_attention as tfa
from g2vlm_tpu_torch.utils import image as timage
from g2vlm_tpu_torch.weights import build_model, state_dict_from_jax

_TINY = tiny_test_config()
# vocab wide enough for the pipeline's crc32 prompt ids (< 5,100)
CFG = dataclasses.replace(_TINY, llm=dataclasses.replace(_TINY.llm, vocab_size=5120))
TOKEN_IDS = dict(bos_token_id=7, eos_token_id=8, start_of_image=11, end_of_image=12)
PREFILL_TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    params = jg.init_params(CFG, jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)
    model = build_model(CFG, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_jax(params, CFG), strict=True)
    return jax.tree.map(jnp.asarray, params), model


@pytest.fixture(scope="module")
def pipes(models):
    params, model = models
    jpipe = JaxPipeline(params, CFG, new_token_ids=dict(TOKEN_IDS), compute_dtype=jnp.float32, seq_pad_multiple=32)
    return jpipe, G2VLMPipeline(model, CFG, new_token_ids=dict(TOKEN_IDS), seq_pad_multiple=32)


def test_weight_round_trip_carries_the_vit(models):
    params, model = models
    sd = state_dict_from_jax(params, CFG)
    assert set(sd) == set(model.state_dict())
    assert sd["vit_model.patch_embed.proj.weight"].shape == (64, 3, 2, 14, 14)
    back = jg.params_from_torch(model.state_dict(), CFG)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    again = build_model(CFG, device="cpu", seed=3).state_dict()
    w = again["vit_model.patch_embed.proj.weight"]
    assert abs(w.std().item() / 0.02 - 1.0) < 0.1 and (again["vit_model.blocks.0.attn.qkv.bias"] == 0).all()


def test_build_model_defaults_to_the_card_and_raises_without_one(tmp_path, capsys):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(CFG)
    with pytest.raises(RuntimeError, match="--device cpu"):
        infer_chat_torch.main(["--tiny", "--synthetic", "1"])
    # --video on a folder of frames answers on the CPU
    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)).save(tmp_path / f"frame_{i}.png")
    answer = infer_chat_torch.main(["--tiny", "--device", "cpu", "--dtype", "float32", "--video", str(tmp_path),
                                    "--num_frames", "2", "--max_length", "3"])
    assert answer in capsys.readouterr().out and all(tok.isdigit() for tok in answer.split())


@pytest.mark.parametrize("with_dino", [True, False], ids=["split", "mixed"])
def test_prefill_with_vit_rows_matches_jax(models, rng, with_dino):
    """Text + dino + ViT rows sort into [und | geo | padding] and run the
    SPLIT layers; without dino rows nothing is geo and the MIXED layers run.
    Hidden states come back in logical order, K/V stay in the sorted order."""
    params, model = models
    grids = [(1, 4, 6), (1, 2, 4)]
    views = [{"patches": rng.standard_normal((int(np.prod(g)), 1176)).astype(np.float32), "grid_thw": g}
             for g in grids]
    pats, coords, seg, n_real = tvit.pack_views(views, pad_to=32)
    imgs = rng.standard_normal((2, 3, 56, 70)).astype(np.float32) * 0.3 if with_dino else None
    pre = []
    for mod in (jg, tg):
        b = mod.SequenceBuilder(11, 12)
        b.add_text([7, 23, 45, 9])
        if with_dino:
            b.add_dino_images(2, 4, 5)
        for _, gh, gw in grids:
            b.add_vit_image(gh // 2, gw // 2)
        b.add_text([31, 32, 33])
        pre.append(b.build(pad_to=96 if with_dino else 32))
    jpre, tpre = pre
    assert len(tpre.vit_indexes) == n_real == 8
    want_h, want_kv = jg.prefill_hidden(
        params, jpre, None if imgs is None else jnp.asarray(imgs), CFG, vit_patches=jnp.asarray(pats),
        vit_coords=jnp.asarray(coords), vit_seg=jnp.asarray(seg), return_kv=True)
    tfa.reset_launch_counts()
    with torch.inference_mode():
        got_h, got_kv = tg.prefill_hidden(
            model, tpre, None if imgs is None else torch.from_numpy(imgs), CFG, vit_patches=torch.from_numpy(pats),
            vit_coords=coords, vit_seg=seg, return_kv=True)
    n = tpre.seq_len
    real = np.asarray(tpre.doc_id) >= 0
    np.testing.assert_allclose(got_h.numpy()[real], np.asarray(want_h)[real], **PREFILL_TOL)
    assert len(got_kv) == CFG.llm.num_hidden_layers
    for layer, kv in enumerate(got_kv):
        np.testing.assert_allclose(kv.k.numpy()[:n], np.asarray(want_kv["k"][layer])[:n], **PREFILL_TOL)
        np.testing.assert_allclose(kv.v.numpy()[:n], np.asarray(want_kv["v"][layer])[:n], **PREFILL_TOL)
    assert not any(tfa.launch_counts.values())
    # pre-encoded tower tokens in place of images and patches: the same prefill
    with torch.inference_mode():
        vit_emb = tg.encode_vit_to_llm(model, torch.from_numpy(pats), coords, seg)
        dino_emb = tg.encode_dino_to_llm(model, torch.from_numpy(imgs)) if with_dino else None
        again = tg.prefill_hidden(model, tpre, None, CFG, dino_emb=dino_emb, vit_emb=vit_emb)
    np.testing.assert_allclose(again.numpy()[real], got_h.numpy()[real], atol=1e-5, rtol=1e-5)


def test_uniform_grid_prefill_matches_jax(models, rng):
    params, model = models
    grid = (1, 4, 4)
    pats = rng.standard_normal((16, 1176)).astype(np.float32)
    pre = []
    for mod in (jg, tg):
        b = mod.SequenceBuilder(11, 12)
        b.add_text([7, 23])
        b.add_vit_image(2, 2)
        b.add_text([31])
        pre.append(b.build(pad_to=16))
    want, _ = jg.prefill_hidden(params, pre[0], None, CFG, vit_patches=jnp.asarray(pats), vit_grid_hw=grid)
    with torch.inference_mode():
        got = tg.prefill_hidden(model, pre[1], None, CFG, vit_patches=torch.from_numpy(pats), vit_grid_hw=grid)
    n = pre[1].seq_len
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(want)[:n], **PREFILL_TOL)


def _frames(rng, n):
    return [(rng.random((54, 76, 3)) * 255).astype(np.uint8) for _ in range(n)]


def test_chat_from_images_ids_equal_jax(pipes, rng):
    """The host path (PIL preprocess of both towers) through prefill, cache
    build and the greedy loop: the same token ids as the JAX package."""
    jpipe, pipe = pipes
    frames = _frames(rng, 2)
    want, jinfo = jpipe.chat(frames, "which point is closer?", max_new_tokens=5, new_width=56, return_info=True)
    tfa.reset_launch_counts()
    got, info = pipe.chat(frames, "which point is closer?", max_new_tokens=5, new_width=56, return_info=True)
    assert got == want and len(got.split()) > 0
    assert info["n_views"] == 2 and info["num_tokens"] == len(info["token_ids"])
    assert info["prefill_len"] == jinfo["prefill_len"] and info["num_tokens"] == jinfo["num_tokens"]
    assert info["t_prefill_s"] == info["t_upload_s"] + info["t_forward_s"] + info["t_cache_s"]
    assert not any(tfa.launch_counts.values())
    # an int8 KV cache changes the numbers a little; the loop still runs to its end in the vocabulary
    quant, qinfo = pipe.chat(frames, "which point is closer?", max_new_tokens=5, new_width=56, return_info=True,
                             quantized_kv=True)
    assert 0 < qinfo["num_tokens"] <= 5 and all(0 <= t < CFG.llm.vocab_size for t in qinfo["token_ids"])


def test_chat_device_preprocess_ids_equal_jax(pipes, rng):
    jpipe, pipe = pipes
    frames = _frames(rng, 2)
    want = jpipe.chat(frames, "what is here?", max_new_tokens=4, new_width=56, device_preprocess=True)
    got = pipe.chat(frames, "what is here?", max_new_tokens=4, new_width=56, device_preprocess=True)
    assert got == want and len(got.split()) > 0
    # frames of two shapes cannot be stacked: the host path runs instead
    odd = [frames[0], frames[1][:50]]
    assert pipe._uniform_frames(odd) is None and pipe._uniform_frames(frames).shape == (2, 54, 76, 3)


def test_chat_view_chunks_equal_one_upload(pipes, rng, monkeypatch):
    """Eight views go up in four chunks, each encoded by both towers before
    the prefill takes the tokens: the same ids as one upload."""
    from g2vlm_tpu_torch.inference import pipeline as tpipeline

    _, pipe = pipes
    frames = _frames(rng, 8)
    chunked = pipe.chat(frames, "layout?", max_new_tokens=3, new_width=56, device_preprocess=True)
    monkeypatch.setattr(tpipeline, "UPLOAD_CHUNKS", 1)
    assert pipe.chat(frames, "layout?", max_new_tokens=3, new_width=56, device_preprocess=True) == chunked


def test_chat_continue_ids_equal_jax(pipes, rng):
    jpipe, pipe = pipes
    frames = _frames(rng, 1)
    want1, jsession = jpipe.chat(frames, "what is here", max_new_tokens=4, new_width=56, return_session=True)
    got1, session = pipe.chat(frames, "what is here", max_new_tokens=4, new_width=56, return_session=True)
    assert got1 == want1
    assert (session.next_rope_pos, session.pending_token, session.capacity) == (
        jsession.next_rope_pos, jsession.pending_token, jsession.capacity)
    rows = int(session.cache.length)
    want2, jsession2 = jpipe.chat_continue(jsession, "and how far away", max_new_tokens=4)
    got2, session2 = pipe.chat_continue(session, "and how far away", max_new_tokens=4)
    assert got2 == want2
    assert int(session2.cache.length) == int(jsession2.cache.length) > rows
    assert session2.next_rope_pos == jsession2.next_rope_pos
    # asking for a session changes nothing of the first answer
    assert pipe.chat(frames, "what is here", max_new_tokens=4, new_width=56) == got1
    tight = session2._replace(capacity=session2.next_rope_pos + 4)
    with pytest.raises(ValueError, match="cache exhausted"):
        pipe.chat_continue(tight, "more", max_new_tokens=4)


def test_token_ids_outside_the_vocabulary_raise(models):
    """The JAX gather clamps an id past the embedding table; the port says so."""
    _, model = models
    b = tg.SequenceBuilder(11, 12)
    b.add_text([7, CFG.llm.vocab_size])
    with pytest.raises(ValueError, match="vocabulary"):
        tg.prefill_hidden(model, b.build(pad_to=8), None, CFG)


def test_serving_options_are_constructor_arguments(models):
    _, model = models
    assert G2VLMPipeline(model, CFG).attn_impl == "auto" and not G2VLMPipeline(model, CFG).attn_pipe
    pipe = G2VLMPipeline(model, CFG, attn_impl="int8", attn_pipe=True)
    assert pipe._attn == dict(attn_impl="int8", attn_pipe=True)
    with pytest.raises(ValueError):
        G2VLMPipeline(model, CFG, attn_impl="pallas_int8")
    assert pipe._start_token() == pipe.new_token_ids["eos_token_id"]
    assert pipe.SYSTEM_PROMPT == JaxPipeline.SYSTEM_PROMPT


def test_infer_chat_script_runs_on_the_cpu(capsys):
    answer = infer_chat_torch.main(["--tiny", "--device", "cpu", "--dtype", "float32", "--synthetic", "1",
                                    "--max_length", "3", "--device_preprocess", "--attn_pipe"])
    out = capsys.readouterr().out
    assert answer in out and all(tok.isdigit() for tok in answer.split())


@pytest.mark.parametrize("shape", [(2, 54, 76, 3), (1, 768, 768, 3)], ids=["upscale", "native_stage"])
def test_device_vit_preprocess_matches_jax(rng, shape):
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jdp.preprocess_vit_frames_device(jnp.asarray(frames), pad_to=shape[0] * 2916 + 4))
    got = tdp.preprocess_vit_frames_device(torch.from_numpy(frames), pad_to=shape[0] * 2916 + 4).numpy()
    assert got.shape == want.shape == (shape[0] * 2916 + 4, 1176)
    # a pixel on a rounding boundary of the uint8 lattice may land one step
    # apart (1/255/std ~ 1.5e-2); everywhere else the two agree to 1e-5
    diff = np.abs(got - want)
    assert (diff > 1e-5).mean() < 1e-4 and diff.max() < 2e-2
    assert tdp.vit_device_grid() == jdp.vit_device_grid() == (1, 54, 54)
    assert tdp.vit_device_grid((300, 420)) == jdp.vit_device_grid((300, 420))


def test_host_side_copies_equal_their_originals(rng):
    """The port keeps its own copies of host numpy modules; these hold them
    equal to the JAX package's."""
    img = (rng.random((60, 90, 3)) * 255).astype(np.uint8)
    (tp, tgrid), (jp, jgrid) = tvp.preprocess_vit_image(img), jvp.preprocess_vit_image(img)
    assert tgrid == jgrid == (1, 54, 54)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tvp.OPENAI_CLIP_MEAN, jvp.OPENAI_CLIP_MEAN)
    np.testing.assert_array_equal(tvp.OPENAI_CLIP_STD, jvp.OPENAI_CLIP_STD)
    for hw in ((768, 768), (300, 420), (30, 2000), (5000, 4000)):
        assert tvp.smart_resize(*hw) == jvp.smart_resize(*hw)
    with pytest.raises(ValueError):
        tvp.smart_resize(20, 100)
    x = rng.standard_normal((3, 56, 84)).astype(np.float32)
    (tp, tgrid), (jp, jgrid) = tvp.tile_patches(x), jvp.tile_patches(x)
    assert tgrid == jgrid
    np.testing.assert_array_equal(tp, jp)
    for args in ((54, 768, "bicubic", True), (768, 756, "bicubic", True), (76, 56, "bilinear", True),
                 (20, 31, "bicubic", False), (31, 20, "bilinear", False)):
        np.testing.assert_array_equal(timage.resize_matrix(*args), jimage.resize_matrix(*args))
    with pytest.raises(ValueError):
        timage.resize_matrix(4, 8, "lanczos")
    assert ttok.START_TOKEN_TEMPLATE == jtok.START_TOKEN_TEMPLATE and ttok.SPECIAL_TOKENS == jtok.SPECIAL_TOKENS

    class Tok:
        eos_token_id = 3

        def __init__(self, ids):
            self.ids = ids

        def encode(self, text, add_special_tokens=False):
            assert text == ttok.START_TOKEN_TEMPLATE and not add_special_tokens
            return self.ids

    for tok in (None, Tok([4, 198]), Tok([])):
        assert ttok.derive_start_token(tok, TOKEN_IDS) == jtok.derive_start_token(tok, TOKEN_IDS)
