#!/usr/bin/env python
"""Point-map evaluation of the PyTorch/CUDA port (counterpart of
eval_points.py): scale-aligned point errors of multi-view reconstruction
against GT depth / pose annotations.

Metrics per scene, after the scale alignment the training loss uses
(weighted-L1 optimal scale, train/loss.align_points_scale):
  * local-abs-rel : mean |s*pred - gt| / |gt| over valid pixels
  * world-rmse    : RMSE of aligned world points in the first-camera frame

  python eval_points_torch.py --jsonl scenes.jsonl --model_path ... --num_views 8
  python eval_points_torch.py --tiny --device cpu                  # synthetic scene, random weights
  python eval_points_torch.py --pseudo_gt_npz ref.npz --pred_npz pred.npz   # host scoring only

Runs the model on the card unless --device cpu is given; the npz mode never
touches the card.
"""

import argparse
import json


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jsonl", type=str, default=None,
                    help="annotated scenes (JsonlReconDataset row format); omit with --tiny to use a synthetic scene")
    ap.add_argument("--model_path", type=str, default=None)
    ap.add_argument("--num_views", type=int, default=8)
    ap.add_argument("--max_scenes", type=int, default=0)
    ap.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--new_width", type=int, default=None, help="resize width (default 518; 140 under --tiny)")
    ap.add_argument("--tiny", action="store_true", help="tiny random-weight config (harness smoke)")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--pseudo_gt_npz", type=str, default=None,
                    help="reference output cache whose world points serve as pseudo-GT")
    ap.add_argument("--pred_npz", type=str, default=None,
                    help="score saved predictions against --pseudo_gt_npz instead of running the model")
    args = ap.parse_args(argv)
    if args.pseudo_gt_npz and not args.pred_npz:
        ap.error("--pseudo_gt_npz currently requires --pred_npz")
    if not args.pseudo_gt_npz and args.jsonl is None and not args.tiny:
        ap.error("--jsonl is required (or pass --tiny for a synthetic scene)")
    return args


def score_points(pred, gt, mask):
    """pred, gt (N, h, w, 3) float32 point maps and mask (N, h, w) bool ->
    (scale, local-abs-rel, world-rmse): the weighted-L1 scale of pred onto gt
    over the masked pixels, then the errors of |scale| * pred there."""
    import numpy as np
    import torch

    from g2vlm_tpu_torch.train.loss import align_points_scale

    m = mask.reshape(1, -1)
    scale = align_points_scale(
        torch.from_numpy(pred.reshape(1, -1, 3) * m[..., None]),
        torch.from_numpy(gt.reshape(1, -1, 3) * m[..., None]),
        torch.from_numpy(m.astype(np.float32)),
    ).numpy()[0]
    diff = np.linalg.norm(abs(scale) * pred - gt, axis=-1)[mask]
    norm = np.linalg.norm(gt, axis=-1)[mask]
    return scale, float(np.mean(diff / np.maximum(norm, 1e-6))), float(np.sqrt(np.mean(diff ** 2)))


def gt_points(frames, hw):
    """GT world points of the annotated frames in the first camera's frame,
    resized (bilinear, antialiased) to the prediction's (h, w), and the mask
    of pixels whose resampled validity stays above 0.99."""
    import numpy as np
    import torch

    from g2vlm_tpu_torch.data.recon_dataset import depth_to_world_points, load_depth
    from g2vlm_tpu_torch.utils.geometry import se3_inverse
    from g2vlm_tpu_torch.utils.image import resize_hw

    w2c0 = se3_inverse(torch.tensor(frames[0]["extrinsics"], dtype=torch.float32)).numpy()
    gts, masks = [], []
    for fr in frames:
        depth = load_depth(fr["depth"], fr.get("depth_scale", 1000.0))
        pts, valid = depth_to_world_points(
            depth, np.asarray(fr["intrinsics"], np.float32), np.asarray(fr["extrinsics"], np.float32))
        pts = pts @ w2c0[:3, :3].T + w2c0[:3, 3]
        gts.append(resize_hw(torch.from_numpy(pts.transpose(2, 0, 1)), hw).numpy().transpose(1, 2, 0))
        masks.append(resize_hw(torch.from_numpy(valid[None].astype(np.float32)), hw).numpy()[0] > 0.99)
    return np.stack(gts), np.stack(masks)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    if args.pseudo_gt_npz:
        ref = dict(np.load(args.pseudo_gt_npz))
        pred_c = dict(np.load(args.pred_npz))
        gt = np.asarray(ref["points"], np.float32)
        pred = np.asarray(pred_c["points"], np.float32)
        if gt.shape != pred.shape:
            raise SystemExit(f"pseudo-GT points {gt.shape} and predicted points {pred.shape} differ in shape")
        scale, abs_rel, rmse = score_points(pred, gt, np.ones(gt.shape[:-1], bool))
        print(f"views={gt.shape[0]} scale={scale:.6f}")
        print(f"local-abs-rel: {abs_rel:.6f}")
        print(f"world-rmse:    {rmse:.6f}")
        return abs_rel, rmse

    import torch

    from g2vlm_tpu_torch.cli import pipeline_for_cli

    if args.jsonl is None:
        import tempfile

        from g2vlm_tpu_torch.data.synthetic import make_tiny_scene_jsonl

        args.jsonl = make_tiny_scene_jsonl(tempfile.mkdtemp(prefix="g2vlm_tiny_"))
    if args.new_width is None:
        args.new_width = 140 if args.tiny else 518
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    pipe = pipeline_for_cli(args.model_path, tiny=args.tiny, visual_und=args.tiny, device=args.device, dtype=dtype)

    abs_rels, rmses = [], []
    n_scenes = 0
    with open(args.jsonl) as f:
        for line in f:
            if not line.strip():
                continue
            frames = json.loads(line)["frames"][: args.num_views]
            if len(frames) < 2 or not all(fr.get("depth") for fr in frames):
                continue
            pred = pipe.recon([fr["image"] for fr in frames], new_width=args.new_width)["points"]
            gt, mask = gt_points(frames, pred.shape[1:3])
            _, abs_rel, rmse = score_points(pred, gt, mask)
            abs_rels.append(abs_rel)
            rmses.append(rmse)
            n_scenes += 1
            if args.max_scenes and n_scenes >= args.max_scenes:
                break

    print(f"scenes={n_scenes}")
    print(f"local-abs-rel: {np.mean(abs_rels):.4f}")
    print(f"world-rmse:    {np.mean(rmses):.4f}")
    return float(np.mean(abs_rels)), float(np.mean(rmses))


if __name__ == "__main__":
    main()
