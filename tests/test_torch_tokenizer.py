"""The port's tokenizer loading against g2vlm_tpu's on the byte-level BPE
vocabulary of tests/bpe_fixture.py, and `infer_chat_torch.py --model_path`
against the JAX pipeline on one checkpoint directory with that vocabulary:
the same prefill ids, first-step logits within 1e-3 (fp32, CPU)."""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import infer_chat_torch
from bpe_fixture import train_tiny_bpe
from g2vlm_tpu.data import images as jimages
from g2vlm_tpu.data import tokenizer as jtok
from g2vlm_tpu.data import vit_preprocess as jvp
from g2vlm_tpu.inference import decoding as jdec
from g2vlm_tpu.inference.pipeline import G2VLMPipeline as JaxPipeline
from g2vlm_tpu.models import g2vlm as jg
from g2vlm_tpu.models import qwen_vit as jvit
from g2vlm_tpu import weights as jw
from g2vlm_tpu_torch.data import tokenizer as ttok
from g2vlm_tpu_torch.inference import decoding as tdec
from torch_checkpoint import CKPT_CFG, random_state_dict, write_checkpoint

QUESTION = "How far is the red point from the blue point?"
CHAT_STRINGS = [
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\n",
    QUESTION + "<|im_end|>\n<|im_start|>assistant",
    "Reconstruct the 3D scene.",
    "\n<|im_start|>user\nWhich image is wider?<|im_end|>\n<|im_start|>assistant",
    ttok.START_TOKEN_TEMPLATE,
]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    return train_tiny_bpe(str(tmp_path_factory.mktemp("vocab")))


def test_load_tokenizer_equals_jax(vocab_dir):
    tok, ids, added = ttok.load_tokenizer(vocab_dir)
    jt, jids, jadded = jtok.load_tokenizer(vocab_dir)
    assert ids == jids and added == jadded == 4 and len(tok) == len(jt)
    assert len(set(ids.values())) == 4 and max(ids.values()) < len(tok)
    for text in CHAT_STRINGS:
        assert tok.encode(text) == jt.encode(text), text
        assert tok.encode(text, add_special_tokens=False) == jt.encode(text, add_special_tokens=False)
    assert ttok.derive_start_token(tok, ids) == jtok.derive_start_token(jt, jids)
    assert ttok.derive_start_token(None, ids) == jtok.derive_start_token(None, jids) == ids["eos_token_id"]
    assert ttok.START_TOKEN_TEMPLATE == jtok.START_TOKEN_TEMPLATE and ttok.SPECIAL_TOKENS == jtok.SPECIAL_TOKENS


def test_load_tokenizer_names_transformers_where_it_is_missing(vocab_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        ttok.load_tokenizer(vocab_dir)


def _round_up(x, m):
    return -(-x // m) * m


def _jax_first_step(jpipe, images, question, new_width):
    """The JAX pipeline's host-path chat prefill (`chat` without
    device_preprocess), its cache and the first decode step's logits."""
    cfg, p = jpipe.cfg, jpipe.cfg.dino_patch_size
    views = jimages.load_views(images, new_width=new_width)
    n, _, h, w = views.shape
    vit_inputs = [jvp.preprocess_vit_image(im) for im in images]
    n_pat = sum(int(np.prod(g)) for _, g in vit_inputs)
    pats, coords, seg, _ = jvit.pack_views([{"patches": x, "grid_thw": g} for x, g in vit_inputs],
                                           pad_to=_round_up(n_pat, 8))
    b = jg.SequenceBuilder(jpipe.new_token_ids["start_of_image"], jpipe.new_token_ids["end_of_image"])
    b.add_text(jpipe._encode_text(jpipe.SYSTEM_PROMPT))
    b.add_dino_images(n, h // p, w // p)
    for _, gh, gw in (g for _, g in vit_inputs):
        b.add_vit_image(gh // 2, gw // 2)
    b.add_text(jpipe._encode_text(question + "<|im_end|>\n<|im_start|>assistant"))
    pre = b.build(pad_to=_round_up(b.curr, jpipe.seq_pad_multiple))
    _, kv = jg.prefill_hidden(jpipe.params, pre, jnp.asarray(jimages.resnet_normalize(views)), cfg,
                              vit_patches=jnp.asarray(pats), vit_coords=jnp.asarray(coords), vit_seg=jnp.asarray(seg),
                              return_kv=True)
    cache = jdec.build_cache(kv, jnp.asarray(pre.seq_len, jnp.int32), cfg.llm, len(pre.doc_id) + 64,
                             dtype=jnp.float32)
    logits, _ = jdec.decode_step(jpipe.params["llm"], cache, jnp.asarray(jpipe._start_token()),
                                 jnp.asarray(int(pre.next_rope_pos)), cfg.llm, compute_dtype=jnp.float32)
    return pre, np.asarray(logits)


def test_infer_chat_torch_model_path_matches_jax(tmp_path, rng, capsys):
    # the model's vocabulary is the tokenizer's, so that every id the random weights generate decodes
    ck = tmp_path / "ckpt"
    train_tiny_bpe(str(ck))
    cfg = dataclasses.replace(CKPT_CFG, llm=dataclasses.replace(CKPT_CFG.llm, vocab_size=len(
        ttok.load_tokenizer(str(ck))[0])))
    write_checkpoint(ck, random_state_dict(cfg), cfg)
    images = []
    for i in range(2):
        path = tmp_path / f"view_{i}.png"
        Image.fromarray(rng.integers(0, 256, (56, 70, 3), dtype=np.uint8)).save(path)
        images.append(str(path))
    argv = ["--model_path", str(ck), "--device", "cpu", "--dtype", "float32", "--image", *images,
            "--question", QUESTION, "--max_length", "4"]
    pipe = infer_chat_torch.build_pipeline(infer_chat_torch.parse_args(argv))
    params, jc = jw.load_checkpoint(str(ck))
    # JSON gives mrope_section as a list, which the JAX decode step cannot hash as a static argument
    jc = dataclasses.replace(jc, llm=dataclasses.replace(jc.llm, mrope_section=tuple(jc.llm.mrope_section)))
    jt, jids, _ = jtok.load_tokenizer(str(ck))
    jpipe = JaxPipeline(params, jc, tokenizer=jt, new_token_ids=jids, compute_dtype=jnp.float32)
    assert pipe.new_token_ids == jids and pipe._start_token() == jpipe._start_token()

    want_pre, want_logits = _jax_first_step(jpipe, images, QUESTION, 518)
    with torch.inference_mode():
        pre, _, kv, _, _ = pipe.chat_prefill(images, QUESTION)
        cache = tdec.build_cache(kv, pre.seq_len, pipe.cfg.llm, len(pre.doc_id) + 64, dtype=torch.float32)
        logits, _ = tdec.decode_step(pipe.model.language_model, cache, pipe._start_token(), int(pre.next_rope_pos),
                                     pipe.cfg.llm, compute_dtype=torch.float32)
    for field in ("text_ids", "text_indexes", "position_ids", "doc_id"):
        np.testing.assert_array_equal(getattr(pre, field), getattr(want_pre, field), err_msg=field)
    assert max(pre.text_ids) < len(jt)  # the vocabulary's ids, not the tokenizer-less crc32 ones
    err = np.abs(logits.numpy() - want_logits).max() / np.abs(want_logits).max()
    assert err < 1e-3, err

    answer = infer_chat_torch.main(argv)
    assert answer in capsys.readouterr().out and "smoke mode" not in answer
