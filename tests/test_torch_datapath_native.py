"""The port's host C++ data path (g2vlm_tpu_torch/csrc) against the JAX
package's (g2vlm_tpu/csrc): the two sources are the same bytes, and the two
entries the training data path calls, `color_jitter_f32` and
`vit_preprocess_u8`, give bitwise equal outputs on seeded inputs, as do their
callers `random_color_augmentation` and `preprocess_vit_image_fast`. The
port's build goes into its `_build/` keyed by a hash of the source, and a
failed build raises with the compiler's message. CPU only."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import g2vlm_tpu.csrc as jnative
import g2vlm_tpu_torch.csrc as tnative
from g2vlm_tpu.data import augment as jaug
from g2vlm_tpu.data import vit_preprocess as jvit
from g2vlm_tpu_torch.data import augment as taug
from g2vlm_tpu_torch.data import vit_preprocess as tvit

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    if jnative.get_lib() is None:  # the JAX loader falls back to numpy without g++; bitwise needs its library
        pytest.fail("the JAX package's native data path did not build (g++ missing?)")


def test_the_two_sources_are_the_same_bytes():
    port, jax_source = REPO / "g2vlm_tpu_torch/csrc/datapath.cpp", REPO / "g2vlm_tpu/csrc/datapath.cpp"
    assert port.read_bytes() == jax_source.read_bytes()


def test_the_library_builds_into_build_keyed_by_the_source():
    path = tnative.build_library()
    assert path.parent == REPO / "g2vlm_tpu_torch" / "_build" and path.name.startswith("libdatapath_")
    assert path == tnative.build_library()  # built once; the second call finds it
    assert not list((REPO / "g2vlm_tpu_torch" / "csrc").glob("*.so"))  # nothing next to the source


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    broken = tmp_path / "datapath.cpp"
    broken.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(tnative, "_SRC", broken)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        tnative.build_library()
    assert "error" in str(e.value)
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("ops,gray", [([0, 1, 2, 3], False), ([3, 2, 1, 0], True), ([2, 0, 3, 1], False),
                                      ([], True), ([1], False)])
def test_color_jitter_is_bitwise_the_jax_packages(rng, ops, gray):
    img = rng.random((3, 37, 53)).astype(np.float32)
    ops = np.asarray(ops, np.int32)
    factors = (1.3, 0.7, 1.45, -0.07)
    want = jnative.color_jitter(img.copy(), ops, *factors, gray)
    got = tnative.color_jitter(img.copy(), ops, *factors, gray)
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_random_color_augmentation_draws_and_pixels_are_the_jax_packages(rng, seed):
    """The same draws in the same order, then the same native pass: bitwise, and the
    generators end in the same state."""
    img = rng.random((3, 28, 42)).astype(np.float32)
    for kw in ({}, dict(jitter_p=0.0, grayscale_p=0.0), dict(grayscale_p=1.0)):
        gj, gt = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(taug.random_color_augmentation(img, gt, **kw),
                                      jaug.random_color_augmentation(img, gj, **kw))
        assert gj.random() == gt.random()


@pytest.mark.parametrize("hw,target", [((64, 80), (56, 56)), ((300, 200), (768, 768)), ((97, 131), (448, 448)),
                                       ((768, 768), (768, 768))])
def test_vit_preprocess_is_bitwise_the_jax_packages(rng, hw, target):
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    want_rows, want_grid = jnative.vit_preprocess(img, target)
    got_rows, got_grid = tnative.vit_preprocess(img, target)
    assert got_grid == want_grid
    np.testing.assert_array_equal(got_rows, want_rows)


def test_preprocess_vit_image_fast_takes_paths_pil_and_arrays_as_the_jax_package(rng, tmp_path, monkeypatch):
    img = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(img).save(path)
    for x in (path, Image.fromarray(img), img, Image.fromarray(img).convert("L")):
        got, want = tvit.preprocess_vit_image_fast(x, (112, 112)), jvit.preprocess_vit_image_fast(x, (112, 112))
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    # G2VLM_NATIVE_VIT=0: the PIL path of both packages
    monkeypatch.setenv("G2VLM_NATIVE_VIT", "0")
    got, want = tvit.preprocess_vit_image_fast(img, (112, 112)), jvit.preprocess_vit_image_fast(img, (112, 112))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], tvit.preprocess_vit_image(img, (112, 112))[0])


def test_vit_preprocess_refuses_what_is_no_rgb_image():
    with pytest.raises(ValueError):
        tnative.vit_preprocess(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError):
        tnative.vit_preprocess(np.zeros((8, 8), np.uint8))
