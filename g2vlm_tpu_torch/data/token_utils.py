"""Token/position utilities.

The port's own copy of g2vlm_tpu/data/token_utils.py, which it does not import;
tests/test_torch_data_helpers.py holds the two equal.

Behavioral spec: reference data/data_utils.py:40-436 — patchify, flattened
ViT position ids (extrapolate/interpolate), 3D mRoPE index generators,
split_integer_exp_decay, pil_img2rgb, and the Qwen chat templates with
<vit_image>/<dino_image> placeholders. (The attention-mask builders live in
ops/masks.py; len2weight in data/packing.py.)"""

from __future__ import annotations

import math
import random
import re
from typing import Dict, List, Tuple

import numpy as np


def patchify(image: np.ndarray, patch_size: int) -> np.ndarray:
    """(C, H, W) -> (hw, p*p*C) rows ordered (h, w, ph, pw, c) (reference
    data_utils.py:40-47)."""
    c, h, w = image.shape
    p = patch_size
    assert h % p == 0 and w % p == 0
    x = image.reshape(c, h // p, p, w // p, p)
    x = np.einsum("chpwq->hwpqc", x)
    return x.reshape(-1, p * p * c)


def get_flattened_position_ids_extrapolate(
    img_h: int, img_w: int, patch_size: int, max_num_patches_per_side: int
) -> np.ndarray:
    """(reference data_utils.py:50-55)."""
    nh, nw = img_h // patch_size, img_w // patch_size
    ch = np.arange(nh)
    cw = np.arange(nw)
    return (ch[:, None] * max_num_patches_per_side + cw).reshape(-1)


def get_flattened_position_ids_interpolate(
    img_h: int, img_w: int, patch_size: int, max_num_patches_per_side: int
) -> np.ndarray:
    """(reference data_utils.py:66-74)."""
    nh, nw = img_h // patch_size, img_w // patch_size
    boundaries = np.arange(
        1 / max_num_patches_per_side, 1.0, 1 / max_num_patches_per_side
    )
    fh = np.arange(0, 1 - 1e-6, 1 / nh)
    fw = np.arange(0, 1 - 1e-6, 1 / nw)
    bh = np.searchsorted(boundaries, fh, side="right")
    bw = np.searchsorted(boundaries, fw, side="right")
    return (bh[:, None] * max_num_patches_per_side + bw).reshape(-1)


def get_rope_index_image_3d(
    grid_thw: Tuple[int, int, int], curr_position_id: int, merge: int = 1
) -> Tuple[np.ndarray, int]:
    """3D mRoPE ids for one image (reference get_rope_index_image_3D[_dino],
    data_utils.py:78-201). Returns ((3, n_tokens), delta=max-min)."""
    t, h, w = grid_thw
    gh, gw = h // merge, w // merge
    ti = np.repeat(np.arange(t), gh * gw)
    hi = np.tile(np.repeat(np.arange(gh), gw), t)
    wi = np.tile(np.arange(gw), t * gh)
    pos = np.stack([ti, hi, wi]) + curr_position_id
    return pos, int(pos.max() - pos.min())


def split_integer_exp_decay(s: int, ng_sample_decay: float = 1.0):
    """Random integer composition (reference data_utils.py:242-251)."""
    if ng_sample_decay == 1.0:
        n = random.randint(1, s)
    else:
        base = (1 - ng_sample_decay) / (1 - math.pow(ng_sample_decay, s))
        p = [base * math.pow(ng_sample_decay, i) for i in range(s)]
        n = random.choices(list(range(1, s + 1)), p, k=1)[0]
    cumsum = [0] + sorted(random.sample(range(1, s), n - 1)) + [s]
    return [cumsum[i + 1] - cumsum[i] for i in range(len(cumsum) - 1)], cumsum


def pil_img2rgb(image):
    """RGBA-over-white flattening (reference data_utils.py:254-263)."""
    from PIL import Image

    if image.mode == "RGBA" or image.info.get("transparency", None) is not None:
        image = image.convert("RGBA")
        white = Image.new("RGB", image.size, (255, 255, 255))
        white.paste(image, mask=image.split()[3])
        return white
    return image.convert("RGB")


CHAT_SYSTEM = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\n"
CHAT_SUFFIX = "<|im_end|>\n<|im_start|>assistant"
RECON_PROMPT = "Reconstruct the 3D scene."


def apply_template_qwenvl2(
    question_with_image_tokens: str, answer: str, recon_first: bool = False
) -> List[Dict]:
    """Qwen chat template split on <vit_image>/<dino_image> placeholders
    (reference apply_template_qwenvl2[_reconThenUnd], data_utils.py:328-436)."""
    ret = [{"type": "text", "loss": False, "value": CHAT_SYSTEM}]
    if recon_first:
        ret.append({"type": "text", "loss": False, "value": RECON_PROMPT})
    for part in re.split(r"(<vit_image>|<dino_image>)", question_with_image_tokens):
        if not part:
            continue
        if part == "<vit_image>":
            ret.append({"type": "vit", "loss": False, "value": part})
        elif part == "<dino_image>":
            ret.append({"type": "dino", "loss": False, "value": part})
        else:
            ret.append({"type": "text", "loss": False, "value": part})
    ret.append({"type": "text", "loss": False, "value": CHAT_SUFFIX})
    if answer:
        ret.append({"type": "text", "loss": True, "value": "\n" + answer})
    return ret


def apply_template_qwenvl2_recon_then_und(question: str, answer: str):
    return apply_template_qwenvl2(question, answer, recon_first=True)
