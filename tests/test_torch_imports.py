"""The port imports nothing of JAX, nothing of the JAX package and not the
`safetensors` package, and its own copy of the configs equals the JAX
package's field for field."""

import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import g2vlm_tpu.config as jcfg
import g2vlm_tpu.data.images as jimages
import g2vlm_tpu_torch
import g2vlm_tpu_torch.config as tcfg
import g2vlm_tpu_torch.data.images as timages

REPO = Path(__file__).resolve().parent.parent
# the root scripts of the port
_SCRIPTS = ("chip_smoke", "train_torch", "infer_chat_torch", "infer_recon_torch", "eval_points_torch",
            "eval_camera_torch")
# packages the card's machine lacks or the port must not load: the port reads safetensors itself
_BANNED = ("jax", "jaxlib", "optax", "g2vlm_tpu", "safetensors")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(g2vlm_tpu_torch.__path__, "g2vlm_tpu_torch."))


def test_every_port_module_and_script_imports_without_jax():
    """In a fresh interpreter: import every module under g2vlm_tpu_torch and
    the root scripts (import only), then look at sys.modules."""
    modules = _port_modules() + list(_SCRIPTS)
    assert "g2vlm_tpu_torch.train.trainer" in modules and "g2vlm_tpu_torch.config" in modules
    for name in ("cli", "models.qwen_vit", "inference.decoding", "data.vit_preprocess", "data.tokenizer", "utils.ply",
                 "utils.metrics", "utils.rotation", "utils.alignment", "data.synthetic", "data.recon_dataset",
                 "csrc", "data.distributed", "data.cropping", "data.augment", "data.frame_sampling",
                 "data.vlm_dataset", "data.packing", "data.registry", "train.checkpoint", "models.dinov3",
                 "models.segformer", "models.modeling_utils", "data.parquet_dataset", "data.draw_marker",
                 "data.recon_then_und_dataset", "data.video", "data.token_utils", "data.dataset_utils",
                 "data.corruption", "train.dataloader", "parallel.mesh", "parallel.sequence", "parallel.comm"):
        assert "g2vlm_tpu_torch." + name in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {_BANNED!r})\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_no_port_source_names_the_jax_package_in_an_import():
    sources = list((REPO / "g2vlm_tpu_torch").rglob("*.py")) + [REPO / f"{name}.py" for name in _SCRIPTS]
    assert len(sources) > 30
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]):
                root = words[1].split(".")[0]
                assert root not in _BANNED, f"{path.name}: {line.strip()}"


@pytest.mark.parametrize(
    "make",
    [lambda m: m.G2VLMConfig(), lambda m: m.G2VLMConfig(visual_und=False), lambda m: m.tiny_test_config(),
     lambda m: m.tiny_test_config(visual_und=False)],
    ids=["default", "recon_stage", "tiny", "tiny_recon"],
)
def test_port_config_equals_jax_config_field_for_field(make):
    want, got = make(jcfg), make(tcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert got.llm.use_moe == want.llm.use_moe


@pytest.mark.parametrize("name", ["Dinov3Config", "SegformerConfig"])
def test_port_alternate_configs_equal_the_jax_modules_configs(name):
    """The configs of the JAX package's DINOv3 and SegFormer modules, which the
    port keeps in its config.py."""
    import g2vlm_tpu.models.dinov3 as jd3
    import g2vlm_tpu.models.segformer as jseg

    want = getattr(jd3 if name == "Dinov3Config" else jseg, name)()
    got = getattr(tcfg, name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    if name == "Dinov3Config":
        assert got.head_dim == want.head_dim == 64


def test_port_image_constants_equal_the_jax_package(rng):
    import numpy as np

    np.testing.assert_array_equal(timages.RESNET_MEAN, jimages.RESNET_MEAN)
    np.testing.assert_array_equal(timages.RESNET_STD, jimages.RESNET_STD)
    x = rng.random((2, 3, 8, 9)).astype(np.float32)
    np.testing.assert_array_equal(timages.resnet_normalize(x), jimages.resnet_normalize(x))
    frames = [(rng.random((20, 30, 3)) * 255).astype(np.uint8) for _ in range(2)]
    np.testing.assert_array_equal(timages.load_views(frames, new_width=28), jimages.load_views(frames, new_width=28))


def test_the_decoder_family_is_decided_behind_the_language_model():
    """Which decoder family a model has is asked of its language model: only config.py, the one
    construction in models/g2vlm.py and models/mla_moe_decoder.py compare `layer_module` to
    "mla_moe"; nothing under inference/ or parallel/ but decoding.py's latent step, and not
    models/mot_decoder.py, imports mla_moe_decoder; and decoding.py names no layer attribute (the
    per-token layers live beside their layers)."""
    import ast
    import re

    port = REPO / "g2vlm_tpu_torch"
    compare = re.compile(r"""layer_module\s*(==|!=|in\b)[^\n]*["']mla_moe["']|["']mla_moe["']\s*(==|!=)""")
    found = {path.relative_to(port).as_posix(): len(compare.findall(path.read_text()))
             for path in port.rglob("*.py")}
    assert found.pop("models/g2vlm.py") == 1
    assert not {name: n for name, n in found.items()
                if n and name not in ("config.py", "models/mla_moe_decoder.py")}

    def imports_mla(path):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
                if any("mla_moe_decoder" in n for n in names):
                    return True
        return False

    importing = [path.relative_to(port).as_posix() for path in
                 [*port.glob("inference/*.py"), *port.glob("parallel/*.py"), port / "models" / "mot_decoder.py"]
                 if imports_mla(path)]
    assert importing == ["inference/decoding.py"]
    decoding = (port / "inference" / "decoding.py").read_text()
    assert not re.findall(r"\b(self_attn|mlp|q_proj|kv_b_proj|input_layernorm)\b", decoding)
