"""The port's copies of the data helpers that nothing on the training path
imports (token_utils, dataset_utils, corruption) against the JAX package's
modules on the CPU, on the same seeded inputs: equal results, the random ones
drawn from the global generator seeded alike before each call."""

import random

import numpy as np
import pytest
from PIL import Image

from g2vlm_tpu.data import corruption as jcor
from g2vlm_tpu.data import dataset_utils as jdu
from g2vlm_tpu.data import token_utils as jtu
from g2vlm_tpu_torch.data import corruption as tcor
from g2vlm_tpu_torch.data import dataset_utils as tdu
from g2vlm_tpu_torch.data import token_utils as ttu


def _same(got, want):
    if isinstance(want, Image.Image):
        assert isinstance(got, Image.Image) and got.mode == want.mode and got.size == want.size
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


def _both(name, t_mod, j_mod, *args, seed=0, **kw):
    """The function `name` of both modules on copies of the same arguments, the global generator
    seeded alike before each."""
    out = []
    for mod in (t_mod, j_mod):
        random.seed(seed)
        copies = [a.copy() if hasattr(a, "copy") else a for a in args]
        out.append(getattr(mod, name)(*copies, **kw))
    _same(*out)
    return out[0]


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(0)
    return Image.fromarray(rng.integers(0, 256, (45, 61, 3), dtype=np.uint8))


TOKEN_CASES = {
    "patchify": lambda r: ((r.standard_normal((3, 28, 42)).astype(np.float32), 14), {}),
    "get_flattened_position_ids_extrapolate": lambda r: ((56, 42, 14, 70), {}),
    "get_flattened_position_ids_interpolate": lambda r: ((56, 42, 14, 10), {}),
    "get_rope_index_image_3d": lambda r: (((2, 4, 6), 17), dict(merge=2)),
    "split_integer_exp_decay": lambda r: ((9, 0.7), {}),
    "apply_template_qwenvl2": lambda r: (("Look <vit_image> and <dino_image> here", "Yes."), {}),
    "apply_template_qwenvl2_recon_then_und": lambda r: (("Where? <dino_image>", "There."), {}),
}


@pytest.mark.parametrize("name", sorted(TOKEN_CASES))
def test_token_utils_match(name):
    args, kw = TOKEN_CASES[name](np.random.default_rng(1))
    _both(name, ttu, jtu, *args, **kw)
    assert (ttu.CHAT_SYSTEM, ttu.CHAT_SUFFIX, ttu.RECON_PROMPT) == (jtu.CHAT_SYSTEM, jtu.CHAT_SUFFIX, jtu.RECON_PROMPT)


def test_split_integer_exp_decay_uniform_and_pil_img2rgb_match():
    for seed in range(4):
        parts, cum = _both("split_integer_exp_decay", ttu, jtu, 12, 1.0, seed=seed)
        assert sum(parts) == 12 and cum[-1] == 12
    rgba = np.zeros((6, 7, 4), np.uint8)
    rgba[..., 0], rgba[2:4, 2:5, 3] = 200, 255
    _both("pil_img2rgb", ttu, jtu, Image.fromarray(rgba, "RGBA"))
    _both("pil_img2rgb", ttu, jtu, Image.fromarray(rgba[..., :3]))


@pytest.mark.parametrize("clockwise", [True, False])
def test_dataset_utils_match(clockwise):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    depth = (1.0 + rng.random((40, 56))).astype(np.float32) * 1000.0
    k = np.array([[50.0, 0, 30.0], [0, 50.0, 18.0], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = (0.1, -0.2, 0.3)
    d = _both("transform_depth", tdu, jdu, depth, 1000.0, z_far=1.8)
    _both("crop_image_depth_and_intrinsic_by_pp", tdu, jdu, img, d, k)
    _both("resize_image_depth_and_intrinsic", tdu, jdu, img, d, k, (28, 42))
    _both("rotate_90_degrees", tdu, jdu, img, d, k, c2w, clockwise=clockwise)
    _both("depth_to_world_coords_points", tdu, jdu, d, k, c2w)


CORRUPTIONS = {
    "max_long_edge_min_short_edge_resize": ((40, 16, 8), dict(max_pixels=900)),
    "image_transform": ((40, 16, 8), {}),
    "decolorization": ((), {}),
    "downscale": ((0.37,), {}),
    "random_crop": (((20, 30),), {}),
    "motion_blur": ((5, 30.0), {}),
    "shuffle_patch": (((2, 3),), dict(gap_size=3)),
    "inpainting": (((3, 2),), dict(blank_ratio=0.5)),
}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_corruption_matches(image, name):
    args, kw = CORRUPTIONS[name]
    for seed in range(2):
        _both(name, tcor, jcor, image, *args, seed=seed, **kw)
