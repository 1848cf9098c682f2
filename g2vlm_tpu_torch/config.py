"""Typed configs for the G2VLM model family (the port's own copy of
g2vlm_tpu/config.py, which it does not import; a test holds the two equal
field for field).

Mirrors the reference's JSON config triplet (text_config.json / vit_config.json /
dino_config.json, see reference g2vlm_utils.py:31-50) as plain dataclasses, plus
the top-level assembly config (reference modeling/g2vlm/g2vlm.py:79-117).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass(frozen=True)
class LLMConfig:
    """Qwen2-VL language-model config (reference qwen2vl.py:50-234).

    Defaults are the Qwen2-VL-2B values used by G2VLM-2B-MoT.
    """

    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_hidden_layers: int = 28
    num_attention_heads: int = 12
    num_key_value_heads: int = 2
    hidden_act: str = "silu"
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = False
    # mrope channel split of head_dim//2 (reference modeling_qwen2_vl.py:562-566
    # hardcodes [16, 24, 24])
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    qk_norm: bool = True
    # "dense" | "mot" | "moe"  (reference layer_module Qwen2VLDecoderLayer /
    # Qwen2VLMoTDecoderLayer / Qwen2VLMoEDecoderLayer, qwen2vl.py:1015-1019)
    layer_module: str = "mot"
    layer_scale_init: float = 0.01  # reference qwen2vl.py:765-766
    freeze_und: bool = False
    freeze_recon: bool = False
    # special token ids (Qwen2-VL tokenizer)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    pad_token_id: int = 151643

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def use_moe(self) -> bool:
        return self.layer_module in ("mot", "moe")

    @classmethod
    def from_json(cls, path: str) -> "LLMConfig":
        with open(path) as f:
            d = json.load(f)
        # Map HF layer_module names onto ours.
        lm = d.get("layer_module", "Qwen2VLMoTDecoderLayer")
        d["layer_module"] = {
            "Qwen2VLDecoderLayer": "dense",
            "Qwen2VLMoTDecoderLayer": "mot",
            "Qwen2VLMoEDecoderLayer": "moe",
        }.get(lm, lm)
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True)
class MLAMoEConfig(LLMConfig):
    """Kimi-VL-A3B-Instruct's language model (https://huggingface.co/moonshotai/Kimi-VL-A3B-Instruct,
    `config.json` `text_config`; the DeepSeek-V3 block of its `modeling_deepseek.py`) as G2VLM's
    single-weight-set decoder, `layer_module` "mla_moe" (models/mla_moe_decoder.py). Port-only: the
    JAX package has no such layer, so the fields live on this subclass and `LLMConfig` stays equal to
    the JAX package's field for field.

    Multi-head latent attention without a q-LoRA: q (nope + rope dims a head), a shared latent of
    `kv_lora_rank` plus one `qk_rope_head_dim` rope key a row, `kv_b_proj` up to each head's nope key
    and value; rope in the interleaved-pair form on the rope dims. The first `first_k_dense_replace`
    layers have a dense SwiGLU MLP of `intermediate_size`, the rest `n_routed_experts` SwiGLU experts
    of `moe_intermediate_size` (sigmoid scores, the top `num_experts_per_tok` chosen on scores plus
    the correction bias, weighted by the unbiased scores, normalised and scaled by
    `routed_scaling_factor`) beside `n_shared_experts` always-on ones. Defaults are the published
    values. Its rows take 1-D rope positions (row i of a document at position i, `TokenInfo.pos`)
    instead of the 3-axis mRoPE ids."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    qk_norm: bool = False
    layer_module: str = "mla_moe"
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1408
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a token holds in the decode cache of one layer: the latent and the rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclass(frozen=True)
class VitConfig:
    """Qwen2-VL vision tower config (reference configuration_qwen2_vl.py defaults,
    patch_size forced to 14 by g2vlm_utils.py:39)."""

    depth: int = 32
    embed_dim: int = 1280
    hidden_size: int = 1536  # output dim after PatchMerger
    hidden_act: str = "quick_gelu"
    mlp_ratio: float = 4.0
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @classmethod
    def from_json(cls, path: str) -> "VitConfig":
        with open(path) as f:
            d = json.load(f)
        d["patch_size"] = 14  # reference g2vlm_utils.py:39 forces 14
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True)
class DinoConfig:
    """DINOv2-with-registers config (reference
    modeling/dinov2_with_registers/configuration_dinov2_with_registers.py).
    Defaults = facebook/dinov2-with-registers-large at 518px."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    mlp_ratio: int = 4
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-6
    image_size: int = 518
    patch_size: int = 14
    num_channels: int = 3
    num_register_tokens: int = 4
    layerscale_value: float = 1.0
    use_swiglu_ffn: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_pos_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @classmethod
    def from_json(cls, path: str) -> "DinoConfig":
        with open(path) as f:
            d = json.load(f)
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True)
class Pi3HeadConfig:
    """Pi3 decoder-head geometry (reference g2vlm.py:162-226)."""

    depth: int = 5
    num_heads: int = 16
    mlp_ratio: float = 4.0
    point_out_dim: int = 1024
    camera_out_dim: int = 512
    rope_freq: float = 100.0  # reference g2vlm.py:152-153 ('rope100')
    layer_norm_eps: float = 1e-6


@dataclass(frozen=True)
class Dinov3Config:
    """DINOv3 ViT geometry encoder (the port's copy of g2vlm_tpu/models/dinov3.py's
    config; defaults are the ViT-L/16 widths of the public dinov3-vitl16 config)."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    image_size: int = 512
    patch_size: int = 16
    num_channels: int = 3
    num_register_tokens: int = 4
    layerscale_value: float = 1.0
    rope_theta: float = 100.0
    use_gated_mlp: bool = False
    query_bias: bool = True
    key_bias: bool = False
    value_bias: bool = True
    proj_bias: bool = True
    mlp_bias: bool = True
    pos_embed_shift: Optional[float] = None
    pos_embed_jitter: Optional[float] = None
    pos_embed_rescale: Optional[float] = 2.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class SegformerConfig:
    """SegFormer mit_b0 geometry and its all-MLP head (the port's copy of
    g2vlm_tpu/models/segformer.py's config)."""

    embed_dims: Tuple[int, ...] = (32, 64, 160, 256)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    mlp_ratios: Tuple[int, ...] = (4, 4, 4, 4)
    patch_sizes: Tuple[int, ...] = (7, 3, 3, 3)
    strides: Tuple[int, ...] = (4, 2, 2, 2)
    decoder_dim: int = 256
    num_classes: int = 150
    sky_class: int = 2


@dataclass(frozen=True)
class G2VLMConfig:
    """Top-level assembly config (reference g2vlm.py:79-117)."""

    llm: LLMConfig = field(default_factory=LLMConfig)
    vit: VitConfig = field(default_factory=VitConfig)
    dino: DinoConfig = field(default_factory=DinoConfig)
    pi3: Pi3HeadConfig = field(default_factory=Pi3HeadConfig)
    dinov3: Any = None  # a Dinov3Config when use_dinov3

    visual_und: bool = True
    visual_recon: bool = True
    use_dinov3: bool = False
    train_conf_pi3: bool = False
    use_global_points: bool = True
    use_registers: bool = False
    vit_max_num_patch_per_side: int = 36  # reference g2vlm_utils.py:49
    dino_max_num_patch_per_side: int = 37

    @property
    def dino_patch_size(self) -> int:
        return 16 if self.use_dinov3 else self.dino.patch_size

    @classmethod
    def from_checkpoint_dir(cls, path: str, **overrides) -> "G2VLMConfig":
        """Build from the reference checkpoint-dir JSON triplet
        (reference g2vlm_utils.py:31-50)."""
        import os

        return cls(
            llm=LLMConfig.from_json(os.path.join(path, "text_config.json")),
            vit=VitConfig.from_json(os.path.join(path, "vit_config.json")),
            dino=DinoConfig.from_json(os.path.join(path, "dino_config.json")),
            **overrides,
        )


def tiny_test_config(visual_und: bool = True) -> G2VLMConfig:
    """A small config for fast unit/parity tests.

    Dims respect the reference's hardcoded head counts (Pi3 decoders use 16
    heads and 1024/512 out dims, reference g2vlm.py:162-185) so the same
    config can instantiate the torch reference for golden runs.
    """
    return G2VLMConfig(
        visual_und=visual_und,
        llm=LLMConfig(
            vocab_size=512,
            hidden_size=128,
            intermediate_size=160,
            num_hidden_layers=2,
            num_attention_heads=8,
            num_key_value_heads=2,
            mrope_section=(2, 3, 3),
        ),
        vit=VitConfig(depth=2, embed_dim=64, hidden_size=128, num_heads=4),
        dino=DinoConfig(
            hidden_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            image_size=56,
            patch_size=14,
        ),
        pi3=Pi3HeadConfig(depth=5, num_heads=16),
    )


def tiny_mla_moe_config() -> G2VLMConfig:
    """`tiny_test_config` with a tiny "mla_moe" decoder (one dense layer, then two MoE layers of 8
    experts, 3 a token, 2 shared) for the CPU tests of the port's Kimi-VL decoder; its vocabulary
    is Qwen2-VL's, so that the pipeline's special token ids fit."""
    base = tiny_test_config()
    return dataclasses.replace(base, llm=MLAMoEConfig(
        vocab_size=151936, hidden_size=128, intermediate_size=160, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, num_experts_per_tok=3,
        moe_intermediate_size=24, n_shared_experts=2, first_k_dense_replace=1))


def cut_depth_config(cfg: G2VLMConfig, layers: int = 2, vocab_size: int = 5120) -> G2VLMConfig:
    """`cfg` at its full widths with `layers` layers in the decoder, DINOv2
    (and DINOv3 where the config has it), the ViT and the Pi3 decoders, and a
    vocabulary of `vocab_size`: the cut that the card's parity checks run, in
    which tokenizer-less text ids (below 5,100) fit. Port-only: the JAX
    package has no such helper."""
    return dataclasses.replace(
        cfg,
        llm=dataclasses.replace(cfg.llm, num_hidden_layers=layers, vocab_size=vocab_size),
        dino=dataclasses.replace(cfg.dino, num_hidden_layers=layers),
        dinov3=None if cfg.dinov3 is None else dataclasses.replace(cfg.dinov3, num_hidden_layers=layers),
        vit=dataclasses.replace(cfg.vit, depth=layers),
        pi3=dataclasses.replace(cfg.pi3, depth=layers),
    )
