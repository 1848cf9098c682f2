"""Video frame sampling on the host: frame indices, a folder of frames, a
video file.

The port's own copy of g2vlm_tpu/data/video.py, which it does not import;
tests/test_torch_video.py holds the two equal. A video file decodes through
PyAV if it is installed, else through the `ffmpeg` command-line tool, as in
the JAX package; a folder of frames needs neither. One difference: where
neither decoder is there, the port raises one error that names both, where
the JAX package lets `subprocess` raise FileNotFoundError for `ffmpeg`.

Behavioral spec: reference data/video_utils.py:19-165 (random / middle / fps
samplers and a folder-of-jpgs reader)."""

from __future__ import annotations

import os
import random
import shutil
import subprocess
import tempfile
from typing import List


def sample_frame_indices(
    num_frames: int, total: int, mode: str = "rand", fps=None, video_fps=None
) -> List[int]:
    """Index selection matching the reference samplers (video_utils.py:87-133):
    'rand' = one random index per uniform bin (from the global `random`
    generator, as the JAX package draws), 'middle' = bin centers, 'fps' =
    fixed-rate subsampling capped at num_frames."""
    if mode == "fps" and fps and video_fps:
        step = max(int(round(video_fps / fps)), 1)
        idx = list(range(0, total, step))
        if len(idx) > num_frames:
            bins = [int(i * len(idx) / num_frames) for i in range(num_frames)]
            idx = [idx[b] for b in bins]
        return idx
    if total <= num_frames:
        return list(range(total))
    edges = [int(i * total / num_frames) for i in range(num_frames + 1)]
    if mode == "middle":
        return [(lo + hi) // 2 for lo, hi in zip(edges[:-1], edges[1:])]
    return [
        random.randint(lo, max(hi - 1, lo)) for lo, hi in zip(edges[:-1], edges[1:])
    ]


def read_frames_folder(path: str, num_frames: int, mode: str = "rand"):
    from PIL import Image

    files = sorted(
        os.path.join(path, f)
        for f in os.listdir(path)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    idx = sample_frame_indices(num_frames, len(files), mode)
    return [Image.open(files[i]).convert("RGB") for i in idx]


def sample_video_frames(path: str, num_frames: int, mode: str = "rand"):
    """Video file or frame directory -> list of PIL images."""
    if os.path.isdir(path):
        return read_frames_folder(path, num_frames, mode)
    try:
        import av  # PyAV, if available

        with av.open(path) as container:
            decoded = [f.to_image() for f in container.decode(container.streams.video[0])]
        idx = sample_frame_indices(num_frames, len(decoded), mode)
        return [decoded[i] for i in idx]
    except ImportError:
        pass
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            f"cannot decode the video {path}: it needs PyAV (the av module) or the ffmpeg command-line tool, "
            "and neither is installed; pass a folder of frames (JPG / PNG) instead")
    # ffmpeg CLI fallback
    from PIL import Image

    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "f_%05d.jpg")
        subprocess.run(
            ["ffmpeg", "-v", "quiet", "-i", path, "-vf", "fps=4", out],
            check=True,
        )
        files = sorted(os.listdir(td))
        idx = sample_frame_indices(num_frames, len(files), mode)
        return [
            Image.open(os.path.join(td, files[i])).convert("RGB") for i in idx
        ]
