#!/usr/bin/env python
"""Multi-view 3D reconstruction CLI of the PyTorch/CUDA port (counterpart of
infer_recon.py): image folder -> .ply point cloud.

Usage:
  python infer_recon_torch.py --image_folder examples/scene \\
      --model_path /path/to/G2VLM-2B-MoT --save_path results/out.ply
  python infer_recon_torch.py --tiny --device cpu --image_folder examples/scene   # CPU smoke

Without --model_path the weights are random (smoke mode): the full-size
recon architecture, or the tiny config with --tiny. Runs on the card unless
--device cpu is given, and raises when the card is asked for and absent.
"""

import argparse
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image_folder", type=str, required=True)
    ap.add_argument("--model_path", type=str, default=None)
    ap.add_argument("--save_path", type=str, default="results/result.ply")
    ap.add_argument("--prompt", type=str, default="Reconstruct the 3D scene.")
    ap.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--new_width", type=int, default=518)
    ap.add_argument("--tiny", action="store_true", help="tiny random-weight config (harness smoke)")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from g2vlm_tpu_torch.cli import pipeline_for_cli
    from g2vlm_tpu_torch.utils.ply import save_ply_visualization

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    # the recon-only architecture in smoke mode, as infer_recon.py builds it
    pipe = pipeline_for_cli(args.model_path, tiny=args.tiny, visual_und=args.tiny, device=args.device, dtype=dtype)
    names = sorted(
        os.path.join(args.image_folder, f)
        for f in os.listdir(args.image_folder)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    print(f"reconstructing {len(names)} views...")
    pred = pipe.recon(names, prompt=args.prompt, new_width=args.new_width)
    os.makedirs(os.path.dirname(args.save_path) or ".", exist_ok=True)
    stats = save_ply_visualization(pred, args.save_path)
    print(f"wrote {args.save_path}: {stats}")
    return stats


if __name__ == "__main__":
    main()
