#!/usr/bin/env python
"""Spatial-QA chat CLI of the PyTorch/CUDA port (counterpart of infer_chat.py):
image(s) + question -> answer, with the 3D reconstruction natively in context.

Usage:
  python infer_chat_torch.py --image a.jpg b.jpg --question "Which point is closer?"
  python infer_chat_torch.py --video clip.mp4 --num_frames 8         # or a folder of JPG / PNG frames
  python infer_chat_torch.py --tiny --device cpu --synthetic 2      # CPU smoke, no image file

With --model_path the weights and the vocabulary come from the checkpoint
directory; without it the weights are random (from --seed) and the text is
the generated token ids. Runs on the card unless --device cpu is given.
"""

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image", type=str, nargs="+", default=None)
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="N random 294x518 uint8 frames from --seed instead of --image")
    ap.add_argument("--video", type=str, default=None,
                    help="video file or frame dir (navigation-style demo, mirrors inference_chat.ipynb); a video "
                         "file needs PyAV or the ffmpeg command-line tool")
    ap.add_argument("--num_frames", type=int, default=8)
    ap.add_argument(
        "--question", type=str,
        default="The red point and blue point in the image mark two positions. Which one is closer to the camera?",
    )
    ap.add_argument("--model_path", type=str, default=None,
                    help="checkpoint dir: text/vit/dino_config.json, model.safetensors and the vocabulary files")
    ap.add_argument("--max_length", type=int, default=100)
    ap.add_argument("--do_sample", action="store_true")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true", help="tiny random-weight config")
    ap.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--attn_int8", action="store_true", help="quantized serving mode: int8 QK^T prefill attention")
    ap.add_argument("--attn_pipe", action="store_true", help="two-stage schedule of the segment attention kernel")
    ap.add_argument("--quantized_kv", action="store_true", help="int8 KV cache")
    ap.add_argument("--device_preprocess", action="store_true",
                    help="preprocess uniform uint8 frames for both towers on the device")
    return ap.parse_args(argv)


def build_pipeline(args):
    """The pipeline of a parsed command line: the checkpoint and its
    vocabulary with --model_path, else random weights from --seed."""
    import torch

    from g2vlm_tpu_torch.cli import pipeline_for_cli

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    return pipeline_for_cli(args.model_path, tiny=args.tiny, device=args.device, dtype=dtype, seed=args.seed,
                            attn_impl="int8" if args.attn_int8 else "auto", attn_pipe=args.attn_pipe)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    pipe = build_pipeline(args)
    if args.synthetic:
        rng = np.random.default_rng(args.seed)
        inputs = list(rng.integers(0, 256, (args.synthetic, 294, 518, 3), dtype=np.uint8))
    elif args.video:
        from g2vlm_tpu_torch.data.video import sample_video_frames

        inputs = sample_video_frames(args.video, args.num_frames)
    elif args.image:
        inputs = args.image
    else:
        raise SystemExit("--image, --video or --synthetic required")
    answer = pipe.chat(
        inputs, args.question, max_new_tokens=args.max_length, do_sample=args.do_sample,
        temperature=args.temperature, seed=args.seed, quantized_kv=args.quantized_kv,
        device_preprocess=args.device_preprocess,
    )
    print(answer)
    return answer


if __name__ == "__main__":
    main()
