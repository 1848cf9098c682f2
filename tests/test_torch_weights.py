"""The port's checkpoint ingest (g2vlm_tpu_torch/weights.py) against the
`safetensors` package and against g2vlm_tpu's ingest on the CPU: the
format reader, the strict two-way load, `audit_keys`, `module_checksums`,
the `--audit` CLI, and recon outputs of a loaded tiny checkpoint (fp32,
within 1e-3 of max|ref|, tests/test_recon_e2e.py's end-to-end tolerance)."""

import dataclasses
import json
import struct
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from g2vlm_tpu import config as jcfg
from g2vlm_tpu import weights as jw
from g2vlm_tpu.inference.pipeline import G2VLMPipeline as JaxPipeline
from g2vlm_tpu.models import g2vlm as jg
from g2vlm_tpu_torch import weights as tw
from g2vlm_tpu_torch.config import G2VLMConfig, tiny_test_config
from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
from torch_checkpoint import CKPT_CFG, TOKEN_IDS, random_state_dict, write_checkpoint

REPO = Path(__file__).resolve().parent.parent
RENAMED = ("language_model.model.layers.0.ls1.gamma", "language_model.model.layers.0.ls1.weight")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    sd = random_state_dict()
    return write_checkpoint(tmp_path_factory.mktemp("ckpt"), sd), sd


def _rewrite(path, sd):
    save_file({k: v.contiguous() for k, v in sd.items()}, str(path / "model.safetensors"))


def _copy_dir(src, dst, sd):
    dst.mkdir()
    for name in ("text_config.json", "vit_config.json", "dino_config.json"):
        (dst / name).write_text((src / name).read_text())
    _rewrite(dst, sd)
    return dst


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32],
                         ids=["F32", "F16", "BF16", "I64", "I32"])
def test_reader_equals_safetensors_bitwise(tmp_path, rng, dtype):
    vals = rng.standard_normal((6, 7, 5)) * 100
    sd = {"a": torch.from_numpy(vals).to(dtype), "b": torch.from_numpy(vals[0, :3]).to(dtype),
          "scalar": torch.tensor(3).to(dtype), "empty": torch.zeros(0, 4, dtype=dtype),
          "other": torch.arange(5, dtype=torch.float32)}
    path = tmp_path / "x.safetensors"
    save_file(sd, str(path))
    got, want = tw.load_safetensors(str(path)), load_file(str(path))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)), k
    got["a"].zero_()  # copy-on-write: the file keeps its bytes
    assert torch.equal(tw.load_safetensors(str(path))["a"], want["a"])


def test_reader_does_not_import_safetensors(ckpt):
    path, _ = ckpt
    code = (
        "import sys\n"
        "from g2vlm_tpu_torch.weights import load_safetensors\n"
        f"sd = load_safetensors({str(path / 'model.safetensors')!r})\n"
        "assert len(sd) > 100\n"
        "assert 'safetensors' not in sys.modules, 'safetensors was imported'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def _header_file(path, header, data=b"", length=None):
    head = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(head) if length is None else length) + head + data)
    return str(path)


@pytest.mark.parametrize("case", ["short", "header_past_end", "overlap", "past_end", "size_mismatch", "dtype"])
def test_corrupt_headers_raise(tmp_path, case):
    e = lambda dt, shape, a, b: {"dtype": dt, "shape": shape, "data_offsets": [a, b]}  # noqa: E731
    path = tmp_path / "bad.safetensors"
    if case == "short":
        path.write_bytes(b"\x01\x02\x03")
        bad = str(path)
    elif case == "header_past_end":
        bad = _header_file(path, {"a": e("F32", [1], 0, 4)}, b"\0" * 4, length=10**6)
    elif case == "overlap":
        bad = _header_file(path, {"a": e("F32", [2], 0, 8), "b": e("F32", [2], 4, 12)}, b"\0" * 12)
    elif case == "past_end":
        bad = _header_file(path, {"a": e("F32", [4], 0, 16)}, b"\0" * 8)
    elif case == "size_mismatch":
        bad = _header_file(path, {"a": e("F32", [3], 0, 8)}, b"\0" * 8)
    else:
        bad = _header_file(path, {"a": e("F64", [1], 0, 8)}, b"\0" * 8)
    with pytest.raises(ValueError):
        tw.load_safetensors(bad)


@pytest.mark.parametrize("visual_und", [True, False], ids=["with_vit", "recon_only"])
def test_model_keys_equal_what_the_jax_mapper_consumes(visual_und):
    """The port's key set is model.state_dict() (no persistent buffer adds a
    key) and equals the keys g2vlm_tpu's params_from_torch reads."""
    cfg = tiny_test_config(visual_und)
    keys = tw.model_keys(cfg)
    model = tw.build_model(cfg, device="cpu", seed=0)
    assert keys == list(model.state_dict())
    rec = jw._RecordingStateDict(model.state_dict())
    jg.params_from_torch(rec, jcfg.tiny_test_config(visual_und))
    assert rec.used == set(keys)


def test_checkpoint_loads_in_both_packages(ckpt, rng):
    path, sd = ckpt
    model, cfg = tw.load_checkpoint(str(path), device="cpu", dtype=torch.float32)
    assert json.dumps(dataclasses.asdict(cfg)) == json.dumps(dataclasses.asdict(CKPT_CFG))
    filed = load_file(str(path / "model.safetensors"))
    got = model.state_dict()
    assert set(got) == set(filed) == set(sd)
    for k, v in filed.items():
        assert torch.equal(got[k], v), k
    params, jc = jw.load_checkpoint(str(path))
    views = rng.random((2, 3, 56, 70)).astype(np.float32)
    want = JaxPipeline(params, jc, new_token_ids=dict(TOKEN_IDS), compute_dtype=jnp.float32).recon_from_views(views)
    out = G2VLMPipeline(model, cfg, new_token_ids=dict(TOKEN_IDS)).recon_from_views(views)
    for key in ("points", "local_points", "camera_poses", "global_points"):
        ref = np.asarray(want[key])
        err = np.abs(out[key].numpy() - ref).max() / np.abs(ref).max()
        assert err < 1e-3, (key, err)
    # a bf16 load casts once on the copy into the model
    bf16, _ = tw.load_checkpoint(str(path), device="cpu", dtype=torch.bfloat16)
    assert all(torch.equal(t, filed[k].to(torch.bfloat16)) for k, t in bf16.state_dict().items())


@pytest.mark.parametrize("fault", ["missing", "extra"])
def test_key_faults_raise_in_both_packages(ckpt, tmp_path, fault):
    path, sd = ckpt
    bad = dict(sd)
    if fault == "missing":
        del bad[RENAMED[0]]
    else:
        bad["point_head.proj.extra_bias"] = torch.zeros(3)
    bad_dir = _copy_dir(path, tmp_path / "bad", bad)
    match = RENAMED[0] if fault == "missing" else "extra_bias"
    with pytest.raises(KeyError, match=match):
        tw.load_checkpoint(str(bad_dir), device="cpu", dtype=torch.float32)
    with pytest.raises(KeyError, match=match):
        jw.load_checkpoint(str(bad_dir))
    if fault == "extra":  # without strict an unconsumed key is tolerated in both, a missing one never
        model, _ = tw.load_checkpoint(str(bad_dir), strict=False, device="cpu", dtype=torch.float32)
        assert torch.equal(model.state_dict()[RENAMED[0]], sd[RENAMED[0]])
        jw.load_checkpoint(str(bad_dir), strict=False)


def test_audit_keys_against_jax(ckpt):
    """A clean checkpoint and one with an extra key give the same dict in both
    packages. On a renamed key both report the old name missing and the new
    one unknown (the assertions of tests/test_recon_e2e.py's audit test); the
    port's lists are exact, where the JAX mapper stops at the missing key and
    so also lists as unknown every key it had not read yet, each of them a
    key the model consumes."""
    _, sd = ckpt
    tiny = jcfg.tiny_test_config()
    jax_cfg = dataclasses.replace(tiny, llm=dataclasses.replace(tiny.llm, vocab_size=CKPT_CFG.llm.vocab_size))
    clean = {k: v.numpy() for k, v in sd.items()}
    assert tw.audit_keys(clean, CKPT_CFG) == jw.audit_keys(clean, jax_cfg) == {"unknown": [], "missing": []}
    extra = dict(clean, **{"point_head.proj.extra": np.zeros(1), "Pi3Loss.point_loss.segformer.w": np.zeros(1),
                           "dino_model.bn.num_batches_tracked": np.zeros(1)})
    assert tw.audit_keys(extra, CKPT_CFG) == jw.audit_keys(extra, jax_cfg) == {
        "unknown": ["point_head.proj.extra"], "missing": []}
    renamed = dict(clean)
    renamed[RENAMED[1]] = renamed.pop(RENAMED[0])
    got, want = tw.audit_keys(renamed, CKPT_CFG), jw.audit_keys(renamed, jax_cfg)
    assert got == {"unknown": [RENAMED[1]], "missing": [RENAMED[0]]}
    assert want["missing"] == got["missing"] and RENAMED[1] in want["unknown"]
    assert set(want["unknown"]) - {RENAMED[1]} <= set(tw.model_keys(CKPT_CFG))
    # two missing keys: the JAX mapper stops at the first it reads, the port lists both in its order
    del renamed["dino2llm.bias"]
    got, want = tw.audit_keys(renamed, CKPT_CFG), jw.audit_keys(renamed, jax_cfg)
    assert got["missing"] == [RENAMED[0], "dino2llm.bias"] and set(want["missing"]) < set(got["missing"])


# the port's top-level modules under the JAX tree's names
_JAX_MODULE = {"language_model": "llm", "dino_model": "dino", "global_points_decoder": "global_decoder",
               "vit_model": "vit"}


def test_module_checksums_equal_jax(ckpt):
    path, _ = ckpt
    model, _ = tw.load_checkpoint(str(path), device="cpu", dtype=torch.float32)
    params, _ = jw.load_checkpoint(str(path))
    want = jw.module_checksums(params)
    got = tw.module_checksums(model)
    assert {_JAX_MODULE.get(m, m) for m in got} == set(want)
    for mod, info in got.items():
        ref = want[_JAX_MODULE.get(mod, mod)]
        assert info["params"] == ref["params"], mod
        assert info["value_sum"] == pytest.approx(ref["value_sum"], rel=1e-6, abs=1e-9), mod
    assert tw.module_checksums(model.state_dict()) == got


def test_audit_cli_exit_codes_equal_jax(ckpt, tmp_path, capsys):
    path, sd = ckpt
    bad = dict(sd)
    bad[RENAMED[1]] = bad.pop(RENAMED[0])
    bad_dir = _copy_dir(path, tmp_path / "bad", bad)
    for ck, rc, verdict in ((path, 0, "AUDIT: PASS"), (bad_dir, 1, "AUDIT: FAIL")):
        proc = subprocess.run([sys.executable, "-m", "g2vlm_tpu_torch.weights", "--audit", str(ck)], cwd=REPO,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == rc, proc.stderr[-2000:]
        assert verdict in proc.stdout
        assert jw._audit_cli(str(ck)) == rc and verdict in capsys.readouterr().out
    assert "per-module checksums" in proc.stdout or "missing" in proc.stdout


def test_load_checkpoint_defaults_to_the_card_and_raises_without_one(ckpt):
    path, _ = ckpt
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.load_checkpoint(str(path))
    assert isinstance(G2VLMConfig.from_checkpoint_dir(str(path)), G2VLMConfig)
