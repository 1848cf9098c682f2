"""The plain reference held to g2vlm_tpu_torch at tiny widths on the CPU, in
float32, and kept apart from the system: it imports nothing of it."""

import ast
import glob
import os

import numpy as np
import pytest
import torch

from benchmark import core, weights
from benchmark.reference import forward, layout, model as ref_model
from benchmark.tests.conftest import tiny_config

REF_DIR = os.path.join(core.BENCH, "reference")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REF_DIR, "*.py"))))
def test_reference_imports_nothing_of_the_system(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "optax", "g2vlm_tpu", "g2vlm_tpu_torch"}, names


@pytest.mark.parametrize("tiny_size", [True, False])
def test_param_shapes_are_the_systems(tiny_size):
    from g2vlm_tpu_torch.models.g2vlm import G2VLM

    cfg = tiny_config() if tiny_size else core.load_json(os.path.join(core.BENCH, "configs", "g2vlm-2b-mot-bf16.json"))
    with torch.device("meta"):
        m = G2VLM(core.program_config(cfg))
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == ref_model.param_shapes(cfg)


def _system(cfg, seed):
    from benchmark.drivers.recon import build

    return build(cfg, seed, "cpu", {})


def _weights(cfg, seed):
    return weights.reference_weights(ref_model.param_shapes(cfg), seed, "cpu", torch.float32)


def test_recon_matches_the_system():
    cfg = tiny_config("float32")
    frames = np.random.default_rng(0).integers(0, 256, (3, 30, 60, 3), dtype=np.uint8)
    got = _system(cfg, 11).recon_from_frames(frames, new_width=56)
    want = forward.recon(_weights(cfg, 11), cfg, torch.as_tensor(frames), 56)
    for k, v in want.items():
        err = (torch.linalg.vector_norm(got[k] - v) / torch.linalg.vector_norm(v)).item()
        assert err < 1e-4, (k, err)


def test_chat_logits_match_the_systems_prefill_and_decode_steps():
    from g2vlm_tpu_torch.inference import decoding

    cfg = tiny_config("float32")
    pipe = _system(cfg, 5)
    frames = list(np.random.default_rng(1).integers(0, 256, (2, 40, 52, 3), dtype=np.uint8))
    question = "how far is the chair from the door"
    prefill, _, kv, _, _ = pipe.chat_prefill(frames, question)
    served = [311, 4017, 99, 151645]
    cap = max(prefill.seq_len + 16, len(prefill.doc_id))
    cache = decoding.build_cache(kv, prefill.seq_len, pipe.cfg.llm, cap, dtype=torch.float32)
    rows = []
    for j, tok in enumerate([layout.EOS] + served[:-1]):
        logits, cache = decoding.decode_step(pipe.model.language_model, cache, tok, prefill.next_rope_pos + j,
                                             pipe.cfg.llm, compute_dtype=torch.float32)
        rows.append(logits)
    want = forward.chat_logits(_weights(cfg, 5), cfg, frames, question, served, "cpu")
    assert want.shape == (len(served), cfg["llm"]["vocab_size"])
    assert torch.allclose(torch.stack(rows), want, atol=2e-4, rtol=1e-4), (torch.stack(rows) - want).abs().max()


def test_chat_layout_is_the_systems_prefill():
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline

    from g2vlm_tpu_torch.config import G2VLMConfig

    pipe = G2VLMPipeline(None, G2VLMConfig())
    q = "which object is nearest to the camera in the first view"
    pre = pipe.build_chat_prefill(3, 28, 37, [(1, 54, 54)] * 3, q)
    lay = layout.chat_layout(3, 28, 37, [(1, 54, 54)] * 3, q)
    s = pre.seq_len
    assert lay.seq_len == s and lay.text_ids == list(pre.text_ids)
    assert np.array_equal(lay.position_ids, pre.position_ids[:, :s])
    assert np.array_equal(lay.fn_id, pre.fn_id[:s]) and np.array_equal(np.asarray(lay.is_geo), pre.is_geo[:s])
    assert lay.rope == pre.next_rope_pos


def test_weights_are_drawn_from_the_seed():
    shapes = ref_model.param_shapes(tiny_config())
    a = weights.reference_weights(shapes, 3, "cpu", torch.bfloat16)
    b = weights.reference_weights(shapes, 3, "cpu", torch.bfloat16)
    c = weights.reference_weights(shapes, 4, "cpu", torch.bfloat16)
    name = "language_model.model.layers.0.self_attn.q_proj.weight"
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a[name], c[name])
    assert abs(a[name].std().item() - 128 ** -0.5) < 0.01
