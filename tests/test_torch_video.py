"""The port's video frame sampling against the JAX package's on the CPU: frame
indices in the three modes (the random one from the global generator, seeded
alike before each call), a folder of frames read bitwise equal, and the port's
one difference: without PyAV and `ffmpeg`, a video file raises an error that
names both."""

import random
import sys

import numpy as np
import pytest
from PIL import Image

from g2vlm_tpu.data import video as jvideo
from g2vlm_tpu_torch.data import video as tvideo


@pytest.mark.parametrize("mode", ["rand", "middle", "fps"])
@pytest.mark.parametrize("num,total", [(8, 64), (8, 8), (8, 5), (12, 100), (3, 10)])
def test_sample_frame_indices_match(mode, num, total):
    kw = dict(fps=2, video_fps=30) if mode == "fps" else {}
    for seed in range(3):
        random.seed(seed)
        got = tvideo.sample_frame_indices(num, total, mode, **kw)
        random.seed(seed)
        want = jvideo.sample_frame_indices(num, total, mode, **kw)
        assert got == want
        assert len(got) == min(num, total) if mode != "fps" else len(got) <= num
        assert all(0 <= i < total for i in got)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """20 PNG frames of 30x40 and two files the reader passes over."""
    folder = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    for i in range(20):
        Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)).save(folder / f"f_{i:03d}.png")
    (folder / "notes.txt").write_text("not a frame")
    (folder / "f_999.bin").write_bytes(b"\0")
    return folder


@pytest.mark.parametrize("mode", ["rand", "middle"])
def test_read_frames_folder_matches(frames, mode):
    """The folder reader and sample_video_frames on the folder: the same frames, pixel for pixel."""
    for read in ("read_frames_folder", "sample_video_frames"):
        out = []
        for mod in (tvideo, jvideo):
            random.seed(1)
            out.append([np.asarray(im) for im in getattr(mod, read)(str(frames), 8, mode)])
        assert len(out[0]) == len(out[1]) == 8
        for got, want in zip(*out):
            assert got.shape == (30, 40, 3)
            np.testing.assert_array_equal(got, want)
    if mode == "middle":  # the bin centres of 20 frames in 8 bins
        files = sorted(frames.glob("*.png"))
        first = np.asarray(Image.open(files[1]).convert("RGB"))
        np.testing.assert_array_equal(out[0][0], first)


def test_a_video_file_without_a_decoder_names_both(tmp_path, monkeypatch):
    """No PyAV and no ffmpeg: the port raises one error naming both, where the JAX package lets
    subprocess raise FileNotFoundError for ffmpeg."""
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"\0" * 64)
    monkeypatch.setitem(sys.modules, "av", None)  # import av -> ImportError
    monkeypatch.setenv("PATH", str(tmp_path))  # no ffmpeg on the path
    with pytest.raises(RuntimeError, match="PyAV.*ffmpeg"):
        tvideo.sample_video_frames(str(clip), 8)
    with pytest.raises(FileNotFoundError):
        jvideo.sample_video_frames(str(clip), 8)
