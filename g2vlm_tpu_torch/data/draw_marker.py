"""Visual-marker drawing for spatial-QA task types.

The port's own copy of g2vlm_tpu/data/draw_marker.py, which it does not
import; tests/test_torch_recon_then_und.py holds the images it draws equal
to the JAX package's, pixel for pixel, for every task type.

Behavioral spec: reference data/draw_marker.py (== data/interleave_datasets/
draw_marker.py): ~40 task types composed from two primitives — filled points
(radius 20) and thick bboxes (stroke 20, 7/8-stroke outset) — with
coordinates given in 0-1000 normalized space, routed to specific views via
point_img_idx / bbox_img_idx, plus labeled variants for video tasks.

Here the task registry is declarative: each task type maps to marker specs
consumed by one `apply` function (the reference's 40 near-identical
functions collapse). Labels are drawn with PIL instead of cv2.putText."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

COLOR_RGB = {
    "red": (255, 0, 0),
    "blue": (0, 0, 255),
    "green": (0, 200, 0),
    "yellow": (225, 225, 0),
}


def scale_point(point, width, height):
    return (np.array(point[0]) / 1000) * np.array([width, height])


def scale_bbox(bbox, width, height):
    return (np.array(bbox[0]) / 1000) * np.array([width, height, width, height])


def draw_point(image, point, color, radius: int = 20, label: Optional[str] = None):
    from PIL import ImageDraw

    draw = ImageDraw.Draw(image)
    p = scale_point(point, image.width, image.height)
    x, y = map(int, p)
    draw.ellipse([x - radius, y - radius, x + radius, y + radius], fill=color)
    if label:
        draw.text((x + radius, y + radius), label, fill=(0, 255, 0))
    return image


def draw_thick_bbox(image, bbox, color, stroke: int = 20, label: Optional[str] = None):
    from PIL import ImageColor, ImageDraw

    draw = ImageDraw.Draw(image)
    b = scale_bbox(bbox, image.width, image.height)
    extend = stroke * 7 / 8
    box = [b[0] - extend, b[1] - extend, b[2] + extend, b[3] + extend]
    if isinstance(color, str):
        color = ImageColor.getrgb(color)
    draw.rectangle(tuple(map(int, box)), outline=color, width=stroke)
    if label:
        draw.text((int(b[0]), int(b[1]) - stroke), label, fill=(0, 255, 0))
    return image


# Declarative task registry. Each spec: (kind, color, data key, slot) where
# slot indexes point_img_idx/bbox_img_idx for multi-view tasks (None = view 0
# or the single image).
_P, _B = "point", "bbox"


def _pts(*colors, mv=False, labels=False):
    return [
        (_P, c, f"{c}_point", (i if mv else None), labels) for i, c in enumerate(colors)
    ]


def _boxes(*colors, mv=False, labels=False, optional=False):
    return [
        (_B, c, f"{c}_bbox", (i if mv else None), labels) for i, c in enumerate(colors)
    ]


TASK_MARKERS: Dict[str, List] = {
    # Single view (reference draw_marker.py:25-77)
    "obj_spatial_relation_oo": _boxes("red", "blue"),
    "depth_prediction_oc": _pts("red", "blue"),
    "depth_prediction_oo": _pts("red", "blue", "green"),
    "distance_prediction_oc": _pts("red"),
    "distance_prediction_oo": _pts("red", "blue"),
    "distance_infer_center_oc": [],
    "distance_infer_center_oo": _pts("red", "blue", "green"),
    "spatial_volume_infer": _boxes("red"),
    "spatial_imagination_oc": _boxes("red", "blue", "green"),
    "spatial_imagination_oo": _boxes("red", "blue", "green", "yellow"),
    # Multi view (:81-254)
    "position_matching": _boxes("red"),
    "view_change_infer": [],
    "depth_prediction_oc_mv": _pts("red", "blue", mv=True),
    "depth_prediction_oo_mv": _pts("red", "blue", "green", mv=True),
    "distance_prediction_oc_mv": _pts("red", mv=True),
    "distance_prediction_oo_mv": _pts("red", "blue", mv=True),
    "obj_spatial_relation_oc_mv": _boxes("red", "blue", "green", optional=True),
    "obj_spatial_relation_oo_mv": _boxes("red", "blue", "green", mv=True, optional=True),
    "distance_infer_center_oc_mv": [],
    "distance_infer_center_oo_mv": ("point_list", False),
    "spatial_imagination_oc_mv": _boxes("red", "blue", "green", mv=True, labels=True),
    "spatial_imagination_oo_mv": _boxes(
        "green", "blue", "red", "yellow", mv=True, labels=True
    ),
    "spatial_imagination_map_mv": _boxes("red", "blue", "green", mv=True, labels=True),
    "camera_motion_infer": [],
    # Video (:255-442)
    "distance_prediction_oo_video": _pts("red", "blue", mv=True),
    "distance_infer_center_oo_video": ("point_list", True),
    "spatial_imagination_oo_video": _boxes(
        "green", "blue", "red", "yellow", mv=True, labels=True
    ),
    "spatial_imagination_oc_video": _boxes(
        "green", "blue", "red", mv=True, labels=True
    ),
    "spatial_imagination_oc_video_hard": _boxes(
        "green", "blue", "red", mv=True, labels=True
    ),
    "spatial_imagination_oo_video_hard": _boxes(
        "green", "blue", "red", "yellow", mv=True, labels=True
    ),
    "obj_frame_locate": [],
    "appearance_order": [],
    "room_size": [],
    "obj_count": [],
    "nav": [],
}


def apply_markers(images, data_entry: Dict, task_type: str):
    """Draw task markers in-place on a list of PIL images (or one image).
    Unknown keys are skipped the way the reference's .get(None) branches do."""
    spec = TASK_MARKERS.get(task_type)
    if spec is None:
        raise KeyError(f"unknown spatial-QA task type: {task_type}")
    single = not isinstance(images, (list, tuple))
    imgs = [images] if single else list(images)

    if isinstance(spec, tuple):  # point_list tasks with object labels
        key, labeled = ("point_list", spec[1])
        idx_list = data_entry.get("point_img_idx", [[0]])[0]
        for i, point in enumerate(data_entry.get(key, [[]])[0]):
            img_i = idx_list[i] if i < len(idx_list) else 0
            label = (
                ("objectA" if i == 0 else f"object{i - 1}") if labeled else None
            )
            draw_point(imgs[img_i], [point], COLOR_RGB["red"], label=label)
        return images

    point_idx = data_entry.get("point_img_idx", [[None] * 8])[0]
    bbox_idx = data_entry.get("bbox_img_idx", [[None] * 8])[0]
    slot_count = 0
    for kind, color, key, slot, labeled in spec:
        if key not in data_entry or data_entry[key] is None:
            continue
        if slot is None:
            img = imgs[0]
        else:
            idxs = point_idx if kind == _P else bbox_idx
            sel = idxs[min(slot_count, len(idxs) - 1)]
            img = imgs[sel if sel is not None else 0]
        label = f"object{slot_count}" if labeled else None
        if kind == _P:
            draw_point(img, data_entry[key], COLOR_RGB.get(color, color), label=label)
        else:
            draw_thick_bbox(img, data_entry[key], color, label=label)
        slot_count += 1
    return images


DRAW_FUNCTIONS = {
    t: (lambda imgs, entry, _t=t: apply_markers(imgs, entry, _t))
    for t in TASK_MARKERS
}
