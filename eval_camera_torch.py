#!/usr/bin/env python
"""Camera-pose AUC evaluation of the PyTorch/CUDA port (counterpart of
eval_camera.py): multi-view reconstruction on annotated scenes (the JSONL
format of JsonlReconDataset), relative-pose AUC@{3,5,10,20,30} of the
predicted cameras against GT.

  python eval_camera_torch.py --jsonl scenes.jsonl --model_path ... --num_views 8
  python eval_camera_torch.py --tiny --device cpu      # synthetic scene, random weights
  python eval_camera_torch.py --self_check             # the metric math alone, no model
  python eval_camera_torch.py --pseudo_gt_npz ref.npz --pred_npz pred.npz   # host scoring only

Runs the model on the card unless --device cpu is given; --self_check and
--pred_npz never touch the card.
"""

import argparse
import json


def _self_check():
    """Metric-math validation on non-degenerate poses (no model).

    With random weights the model's predicted relative translations are tiny,
    so translation-direction AUC from a --tiny model run is quantization
    noise. Here the synthetic scene's real GT arc supplies meaningful
    translation directions, and predictions are the GT composed with KNOWN
    perturbations: the reported errors must equal the injected angles."""
    import tempfile

    import numpy as np

    from g2vlm_tpu_torch.data.synthetic import make_tiny_scene_jsonl
    from g2vlm_tpu_torch.utils.metrics import calculate_auc, camera_to_rel_deg, se3_inverse_np

    path = make_tiny_scene_jsonl(tempfile.mkdtemp(prefix="g2vlm_selfcheck_"), n_frames=6)
    with open(path) as f:
        frames = json.loads(f.readline())["frames"]
    gt_c2w = np.asarray([fr["extrinsics"] for fr in frames], np.float64)
    gt_w2c = se3_inverse_np(gt_c2w)
    rel_t = gt_c2w[1:, :3, 3] - gt_c2w[:-1, :3, 3]
    print(f"synthetic GT: {len(frames)} views, consecutive |t| = "
          f"{np.linalg.norm(rel_t, axis=1).round(4).tolist()} (non-degenerate)")

    def axis_angle(axis, deg):
        axis = np.asarray(axis, np.float64)
        axis = axis / np.linalg.norm(axis)
        a = np.deg2rad(deg)
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)

    ok = True

    # 1) exact predictions -> zero error, AUC 1
    r_deg, t_deg = camera_to_rel_deg(gt_w2c, gt_w2c)
    auc30, _ = calculate_auc(r_deg, t_deg, 30)
    print(f"exact:        max rot err {r_deg.max():.2e} deg, "
          f"max tran err {t_deg.max():.2e} deg, AUC@30 {auc30:.4f}")
    ok &= r_deg.max() < 1e-4 and t_deg.max() < 1e-3 and auc30 > 0.999

    # 2) rotate view 2 by exactly 10 degrees: every pair involving view 2
    # reports 10 deg rotation error, all other pairs 0
    pred = gt_c2w.copy()
    pred[2, :3, :3] = pred[2, :3, :3] @ axis_angle([0.3, 1.0, 0.2], 10.0)
    r_deg, t_deg = camera_to_rel_deg(se3_inverse_np(pred), gt_w2c)
    n = len(frames)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    touched = np.asarray([2 in p for p in pairs])
    print(f"rot 10deg @v2: touched pairs rot err "
          f"[{r_deg[touched].min():.3f}, {r_deg[touched].max():.3f}] deg, "
          f"untouched max {r_deg[~touched].max():.2e} deg")
    ok &= np.allclose(r_deg[touched], 10.0, atol=1e-3)
    ok &= r_deg[~touched].max() < 1e-4

    # 3) perturb view 3's position: translation-direction errors on touched
    # pairs are meaningfully nonzero (degrees-scale, not noise) and grow
    # with the perturbation
    errs = []
    for mag in (0.02, 0.08):
        pred = gt_c2w.copy()
        pred[3, :3, 3] = pred[3, :3, 3] + np.asarray([0.0, mag, 0.0])
        r_deg, t_deg = camera_to_rel_deg(se3_inverse_np(pred), gt_w2c)
        touched = np.asarray([3 in p for p in pairs])
        errs.append(float(np.median(t_deg[touched])))
        auc30, _ = calculate_auc(r_deg, t_deg, 30)
        print(f"tran +{mag}m @v3: touched median tran err {errs[-1]:.2f} deg, "
              f"untouched max {t_deg[~touched].max():.2e} deg, "
              f"AUC@30 {auc30:.4f}")
        ok &= t_deg[~touched].max() < 1e-3
    ok &= 1.0 < errs[0] < errs[1] < 179.0

    print("SELF-CHECK", "PASS" if ok else "FAIL")
    return 0 if ok else 1


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
    ap.add_argument("--images", type=str, default=None, help="frames directory for --pseudo_gt_npz mode")
    ap.add_argument("--pseudo_gt_npz", type=str, default=None,
                    help="reference output cache whose camera_poses serve as pseudo-GT for the frames in --images")
    ap.add_argument("--pred_npz", type=str, default=None,
                    help="score saved predictions against --pseudo_gt_npz instead of running the model")
    ap.add_argument("--self_check", action="store_true",
                    help="validate the metric math on non-degenerate synthetic poses (no model involved)")
    args = ap.parse_args(argv)
    if args.self_check:
        return args
    if args.pred_npz is not None and args.pseudo_gt_npz is None:
        # the single cached prediction would be scored against every jsonl scene
        ap.error("--pred_npz requires --pseudo_gt_npz (saved predictions are a single scene's output)")
    if args.pseudo_gt_npz and args.pred_npz is None and args.images is None:
        ap.error("--pseudo_gt_npz without --pred_npz needs --images")
    if args.jsonl is None and args.pseudo_gt_npz is None and not args.tiny:
        ap.error("--jsonl is required (or pass --tiny for a synthetic scene)")
    return args


def camera_errors(pred_c2w, gt_c2w):
    """(N, 4, 4) predicted and GT camera-to-world poses -> all-pairs relative
    rotation and translation-direction errors in degrees."""
    import numpy as np

    from g2vlm_tpu_torch.utils.metrics import camera_to_rel_deg, se3_inverse_np

    return camera_to_rel_deg(se3_inverse_np(np.asarray(pred_c2w, np.float64)),
                             se3_inverse_np(np.asarray(gt_c2w, np.float64)))


def scenes(args):
    """Yields (image paths or None, gt_c2w (N, 4, 4))."""
    import glob

    import numpy as np

    if args.pseudo_gt_npz:
        gt = np.asarray(np.load(args.pseudo_gt_npz)["camera_poses"], np.float64)
        paths = None
        if args.images:
            paths = sorted(glob.glob(f"{args.images}/*.png") + glob.glob(f"{args.images}/*.jpg"))[: len(gt)]
            if len(paths) != len(gt):
                raise SystemExit(f"{len(paths)} frames in {args.images} for {len(gt)} pseudo-GT poses")
        yield paths, gt
        return
    with open(args.jsonl) as f:
        for line in f:
            if not line.strip():
                continue
            frames = json.loads(line)["frames"][: args.num_views]
            if len(frames) < 2:
                continue
            yield [fr["image"] for fr in frames], np.asarray([fr["extrinsics"] for fr in frames], np.float64)


def main(argv=None):
    args = parse_args(argv)
    if args.self_check:
        raise SystemExit(_self_check())
    import numpy as np

    from g2vlm_tpu_torch.utils.metrics import calculate_auc

    pipe = pred_cache = None
    if args.pred_npz is not None:
        pred_cache = dict(np.load(args.pred_npz))
    else:
        import torch

        from g2vlm_tpu_torch.cli import pipeline_for_cli

        if args.jsonl is None and args.pseudo_gt_npz is None:
            import tempfile

            from g2vlm_tpu_torch.data.synthetic import make_tiny_scene_jsonl

            args.jsonl = make_tiny_scene_jsonl(tempfile.mkdtemp(prefix="g2vlm_tiny_"))
        dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
        pipe = pipeline_for_cli(args.model_path, tiny=args.tiny, visual_und=False, device=args.device, dtype=dtype)
    if args.new_width is None:
        args.new_width = 140 if args.tiny else 518

    all_r, all_t = [], []
    n_scenes = 0
    for paths, gt_c2w in scenes(args):
        out = pred_cache if pred_cache is not None else pipe.recon(paths, new_width=args.new_width)
        # predicted poses are cam -> frame 0; compare relative pose errors
        r_deg, t_deg = camera_errors(out["camera_poses"], gt_c2w)
        all_r.append(r_deg)
        all_t.append(t_deg)
        n_scenes += 1
        if args.max_scenes and n_scenes >= args.max_scenes:
            break

    r, t = np.concatenate(all_r), np.concatenate(all_t)
    print(f"scenes={n_scenes} pairs={len(r)}")
    aucs = {}
    for th in (3, 5, 10, 20, 30):
        aucs[th], _ = calculate_auc(r, t, th)
        print(f"AUC@{th}: {aucs[th]:.4f}")
    return aucs


if __name__ == "__main__":
    main()
