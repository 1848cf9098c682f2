#!/usr/bin/env python
"""Training entry point of the PyTorch port (the counterpart of train.py on
one NVIDIA GPU): joint CE + Pi3 3D training with EMA, checkpoints and
resuming, on packs from a data config or on synthetic packs.

Smoke on the CPU (tiny model, fp32):
  python train_torch.py --tiny --synthetic --steps 2 --device cpu

Real data: a YAML of dataset groups (configs/joint_train.yaml's layout; the
`recon` and `vlm_sft` groups, each dataset's JSONL under `dataset_info`),
packed by data/packing.py; `--max_vit_patches` > 0 adds the Qwen2-VL ViT and
its branch of the training step; checkpoints every `--ckpt_every` steps into
`--checkpoint_dir`, and `--resume` continues from the newest one, data
cursors included:
  python train_torch.py --data_config joint.yaml --max_vit_patches 23328 \\
      --split_layout --freeze_recon --checkpoint_dir ckpts [--resume]

The recon stage at full width on one H100 (16 views of 294x518 in a
12,800-token pack, und expert frozen, factored Adam with a bf16 first moment):
  python train_torch.py --synthetic --views 16 --hw 294 518 --tokens 12800 \\
      --split_layout --freeze_und --factored_v --mu_dtype bfloat16 --steps 10

From a reference checkpoint directory (fp32 masters from its weights, the
vocabulary from its tokenizer files); `--bootstrap_moe` then copies the base
expert's weights into the geo expert's:
  python train_torch.py --synthetic --model_path /path/to/G2VLM-2B-MoT --steps 10 [--bootstrap_moe]

The conf-head stage: the Pi3 confidence decoder and head trained with the
sky-gated BCE, the frozen SegFormer's sky masks from --segformer_pth, the
checkpoint's `Pi3Loss.*` keys, or random weights drawn from the seed:
  python train_torch.py --synthetic --views 16 --hw 294 518 --tokens 12800 \
      --split_layout --freeze_und --factored_v --mu_dtype bfloat16 --train_conf [--segformer_pth seg.pth]

Runs on `cuda` unless `--device cpu` is given, and raises when `cuda` is
asked for and absent.

On several GPUs (or CPU processes), under torchrun: the world's ranks form
train.py's mesh, fsdp = world / (dp * tp) (parallel/mesh.py: FSDP2 over dp and
fsdp, tensor parallelism in the decoder over tp), NCCL on `cuda` and gloo on
`--device cpu`; `--sequence_parallel` splits the decoder's attention over the
fsdp ranks. Rank 0 logs and writes the checkpoints. A process started without
torchrun is a world of one and builds no process group:
  torchrun --nproc_per_node 4 train_torch.py --tiny --synthetic --device cpu --tp 2 --sequence_parallel --steps 2
"""

import argparse
import dataclasses
import itertools
import os


# the vocabulary the tokenizer-less text ids (hash(word) % 5000 + 100) and the four special tokens above
# them need
_HASH_VOCAB = 5104


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--weight_decay", type=float, default=0.05)
    ap.add_argument("--ema_decay", type=float, default=0.9999)
    ap.add_argument("--mu_dtype", type=str, default=None, choices=[None, "float32", "bfloat16"],
                    help="first-moment storage dtype; bfloat16 saves 2 bytes per trainable parameter")
    ap.add_argument("--factored_v", action="store_true",
                    help="Adafactor-style factored second moments (an approximation of Adam's nu)")
    ap.add_argument("--freeze_und", action="store_true", help="freeze the und expert")
    ap.add_argument("--freeze_recon", action="store_true", help="freeze the geo expert + recon towers/heads")
    ap.add_argument("--split_layout", action="store_true",
                    help="SPLIT expert layout: the pack is sorted [und | geo] and each expert runs on "
                         "its contiguous slice (MIXED computes both experts on every row)")
    ap.add_argument("--remat_group", type=int, default=1,
                    help="checkpoint every N layers of the MoT decoder (N must divide the layer count)")
    ap.add_argument("--dino_remat_group", type=int, default=1, help="the same for the DINOv2 encoder")
    ap.add_argument("--no_inner_remat", action="store_true",
                    help="with --remat_group N: keep only the group checkpoint")
    ap.add_argument("--head_view_chunk", type=int, default=0,
                    help="run the Pi3 heads over view chunks of this size (0 = off)")
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--profile_dir", type=str, default=None, help="torch.profiler trace of steps 5-7")
    ap.add_argument("--tiny", action="store_true", help="tiny config in fp32 (tests)")
    ap.add_argument("--cut_depth", type=int, default=0,
                    help="port only: the full-width config with this many layers per tower and a vocabulary of "
                         "5,120, in which tokenizer-less ids fit (the card's checks; 0 = the full depth)")
    ap.add_argument("--synthetic", action="store_true", help="synthetic data (no datasets needed)")
    ap.add_argument("--views", type=int, default=None, help="full-size synthetic pack: number of views")
    ap.add_argument("--hw", type=int, nargs=2, default=(294, 518), help="full-size synthetic pack: view size")
    ap.add_argument("--tokens", type=int, default=12800, help="full-size synthetic pack: padded length")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--model_path", type=str, default=None,
                    help="checkpoint dir: text/vit/dino_config.json, model.safetensors and the vocabulary files")
    ap.add_argument("--data_config", type=str, default=None, help="YAML of dataset groups (real data)")
    ap.add_argument("--tokenizer_path", type=str, default=None,
                    help="tokenizer dir (vocab.json / merges.txt) for the data config's text without --model_path; "
                         "without either, text ids come from a hash of each word")
    ap.add_argument("--max_num_tokens", type=int, default=36864)
    ap.add_argument("--expected_num_tokens", type=int, default=None,
                    help="packer emit threshold (default 8/9 of --max_num_tokens)")
    ap.add_argument("--image_num_range", type=int, nargs=2, default=(2, 24),
                    help="the range of the view count the packer draws per pack")
    ap.add_argument("--max_vit_patches", type=int, default=0,
                    help="ViT patch-row slots per pack (0 = no ViT branch; > 0 for joint recon + und data)")
    ap.add_argument("--geo_start_bucket", type=int, default=256)
    ap.add_argument("--checkpoint_dir", type=str, default="ckpts")
    ap.add_argument("--ckpt_every", type=int, default=500)
    ap.add_argument("--keep_ckpts", type=int, default=2)
    ap.add_argument("--resume", action="store_true", help="continue from the newest checkpoint in --checkpoint_dir")
    ap.add_argument("--bootstrap_moe", action="store_true",
                    help="with --model_path: copy the base expert's weights into the geo expert's (reference init_moe)")
    ap.add_argument("--train_conf", action="store_true",
                    help="train the Pi3 conf decoder and head with the sky-gated BCE; the frozen SegFormer's sky "
                         "masks come from --segformer_pth, the checkpoint's Pi3Loss.* keys, or random weights")
    ap.add_argument("--segformer_pth", type=str, default=None,
                    help="the reference's segformer.b0.512x512.ade.160k.pth for real sky supervision (a pickle: "
                         "load only a file you trust)")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel replicas (the mesh's dp axis)")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks in the decoder (the mesh's tp axis)")
    ap.add_argument("--sequence_parallel", action="store_true",
                    help="split the decoder's attention over the fsdp ranks (ignored when fsdp is 1)")
    args = ap.parse_args(argv)
    if not args.synthetic and not args.data_config:
        raise ValueError("no data: pass --data_config <yaml> for real data or --synthetic for synthetic packs")
    return args


def synthetic_batches(cfg, seed=0, device=None, start=0, dp=1, dp_rank=0):
    """Endless stream of (TrainBatch with a leading batch axis of 1, geo_start
    None): the tiny two-view pack of train.py's `synthetic_batches`, in the
    unsorted layout (MIXED expert mode), from step `start` on (a resumed run
    continues the stream, where train.py's starts it over). Data-parallel
    rank `dp_rank` of `dp` takes train.py's batch row `dp_rank` of each step,
    drawn from seed + step * dp + dp_rank."""
    import numpy as np

    from g2vlm_tpu_torch.models.g2vlm import SequenceBuilder
    from g2vlm_tpu_torch.train.trainer import TrainBatch

    n, h, w = 2, 56, 56
    hp = wp = h // cfg.dino_patch_size
    for step in itertools.count(start):
        rng = np.random.default_rng(seed + step * dp + dp_rank)
        b = SequenceBuilder(11, 12)
        b.add_text([7, 23, 45])
        b.add_dino_images(n, hp, wp)
        b.add_text(list(rng.integers(20, 400, 5)))
        pre = b.build(pad_to=64)
        ce_idx = np.asarray([pre.seq_len - 3, pre.seq_len - 2, pre.seq_len - 1])
        yield _batch_from_prefill(
            pre, ce_idx, rng.integers(0, cfg.llm.vocab_size, 3), rng, n, h, w, device
        ), None


def _batch_from_prefill(pre, ce_idx, ce_labels, rng, n, h, w, device, positive_depth=False):
    """A TrainBatch (leading axis 1) of one packed sequence with random
    images and geometry; identity extrinsics, 90% of the pixels valid. The
    random draws follow train.py's order. With `positive_depth` every point
    lies in front of its camera (depth >= 1.5), which keeps the loss's
    inverse-depth weights bounded; without it the points are plain normal
    draws, as train.py's are."""
    import numpy as np

    from g2vlm_tpu_torch.train.trainer import TrainBatch

    images = rng.standard_normal((n, 3, h, w)).astype(np.float32)
    world_points = rng.standard_normal((1, n, h, w, 3)).astype(np.float32)
    if positive_depth:
        world_points[..., 2] = np.abs(world_points[..., 2]) + 1.5

    fields = dict(
        text_ids=pre.text_ids.astype(np.int32),
        text_indexes=pre.text_indexes.astype(np.int32),
        dino_indexes=pre.dino_indexes.astype(np.int32),
        vit_indexes=np.zeros((0,), np.int32),
        is_geo=pre.is_geo,
        position_ids=pre.position_ids,
        doc_id=pre.doc_id,
        fn_id=pre.fn_id,
        noise_id=pre.noise_id,
        pos=pre.pos,
        ce_indexes=np.asarray(ce_idx, np.int32),
        ce_labels=np.asarray(ce_labels, np.int32),
        ce_weights=np.ones(len(ce_idx), np.float32),
        dino_images=images,
        world_points=world_points,
        point_masks=(rng.random((1, n, h, w)) < 0.9),
        extrinsics=np.tile(np.eye(4, dtype=np.float32), (1, n, 1, 1)),
        normal_batch_mask=np.ones((1,), bool),
    )
    return TrainBatch.from_numpy(device=device, **{k: v[None] for k, v in fields.items()})


def full_size_batch(cfg, views, hw, tokens, seed=0, device=None):
    """One full-size synthetic pack in the sorted [und | geo] layout: a prompt
    and a question (text first), then `views` DINOv2 views, padded to
    `tokens`; CE on the last 16 text tokens; every point in front of its
    camera. Returns (TrainBatch with a leading axis of 1, geo_start)."""
    import numpy as np

    from g2vlm_tpu_torch.models.g2vlm import SequenceBuilder

    h, w = hw
    p = cfg.dino_patch_size
    rng = np.random.default_rng(seed)
    v = cfg.llm.vocab_size  # special tokens at the top of the vocab, as train.py places them without a tokenizer
    text_hi = min(5000, v - 4)
    b = SequenceBuilder(v - 2, v - 1)
    b.add_text([v - 4] + list(rng.integers(100, text_hi, 6)))
    b.add_text(list(rng.integers(100, text_hi, 24)))
    n_ce = 16
    ce_idx = np.arange(b.curr - n_ce, b.curr)
    geo_start = b.curr  # the [und | geo] boundary; padding rows land on the geo side
    b.add_dino_images(views, h // p, w // p)
    if b.curr > tokens:
        raise ValueError(f"{views} views of {h}x{w} need {b.curr} tokens, more than --tokens {tokens}")
    pre = b.build(pad_to=tokens)
    ce_labels = rng.integers(0, cfg.llm.vocab_size, n_ce)
    return _batch_from_prefill(pre, ce_idx, ce_labels, rng, views, h, w, device, positive_depth=True), geo_start


def packer_batches(args, data_cfg, cfg, new_token_ids, tokenizer, data_status, device=None):
    """Real data: the data config's dict -> dataset groups -> packer -> an
    endless stream of (TrainBatch with a leading batch axis of 1, geo_start,
    the pack's data_indexes, the packer's resume status after it). The group
    draws come from a generator seeded with --seed, so that a run and its
    resumption see the same packs; `data_status` (a checkpoint's) fast-forwards
    the datasets and the packer."""
    import random

    from g2vlm_tpu_torch.data.packing import PackedIterableDataset, PackerConfig
    from g2vlm_tpu_torch.data.registry import build_groups_from_config

    groups = build_groups_from_config(data_cfg, tokenizer=tokenizer, data_status=data_status)
    if new_token_ids is None:
        # no tokenizer: the special tokens sit at the top of the vocabulary, where
        # add_special_tokens appends them
        v = cfg.llm.vocab_size
        new_token_ids = dict(bos_token_id=v - 4, eos_token_id=v - 3, start_of_image=v - 2, end_of_image=v - 1)
    expected = args.expected_num_tokens or args.max_num_tokens * 8 // 9
    packed = PackedIterableDataset(
        groups,
        new_token_ids,
        PackerConfig(
            expected_num_tokens=expected,
            max_num_tokens_per_sample=min(16384, args.max_num_tokens // 2),
            max_num_tokens=args.max_num_tokens,
            image_num_range=tuple(args.image_num_range),
            sorted_layout=args.split_layout,
            geo_start_bucket=args.geo_start_bucket,
            max_vit_patches=args.max_vit_patches,
        ),
        group_rng=random.Random(args.seed),
        resume=data_status,
    )
    for b in packed:
        yield batch_from_pack(b, device), b.get("geo_start"), b.get("data_indexes", []), packed.resume_status()


def batch_from_pack(b, device=None):
    """A packer's batch dict (data/packing.py `to_batch`) -> TrainBatch with a
    leading batch axis of 1, as train.py's packer_batches builds it."""
    import numpy as np

    from g2vlm_tpu_torch.train.trainer import TrainBatch

    fields = {k: b[k] for k in (
        "text_ids", "text_indexes", "dino_indexes", "vit_indexes", "is_geo", "position_ids", "doc_id", "fn_id",
        "noise_id", "pos", "ce_indexes", "ce_labels", "ce_weights", "dino_images")}
    fields.update(world_points=b["world_points"][None], point_masks=b["point_masks"][None],
                  extrinsics=b["extrinsics"][None], normal_batch_mask=np.ones((1,), bool))
    for k in ("vit_patches", "vit_coords", "vit_seg"):
        if b.get(k) is not None:
            fields[k] = b[k]
    return TrainBatch.from_numpy(device=device, **{k: v[None] for k, v in fields.items()})


def main(argv=None):
    args = parse_args(argv)
    data_cfg = None
    if args.data_config:
        from g2vlm_tpu_torch.data.registry import load_yaml_config

        data_cfg = load_yaml_config(args.data_config)
    return train(args, data_cfg)


def init_distributed(args):
    """(world size, rank, device, whether the group was made here): under
    torchrun (WORLD_SIZE > 1 in the environment) the process group, NCCL on
    `cuda` (one card per LOCAL_RANK) or gloo on the CPU, unless the caller
    made it; otherwise a world of one and no process group."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs an NVIDIA GPU; pass --device cpu for the CPU")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return 1, 0, torch.device(args.device), False
    import torch.distributed as dist

    rank, local_rank = int(os.environ["RANK"]), int(os.environ.get("LOCAL_RANK", "0"))
    if args.device == "cuda":
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
    else:
        device = torch.device("cpu")
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo", rank=rank, world_size=world)
    return world, rank, device, made


def train(args, data_cfg=None):
    """The training loop of `main`, after the data config (if any) was read
    into `data_cfg`. Returns the final TrainState."""
    import torch

    from g2vlm_tpu_torch.config import G2VLMConfig, cut_depth_config, tiny_test_config
    from g2vlm_tpu_torch.data.packing import fold_data_status
    from g2vlm_tpu_torch.train import trainer
    from g2vlm_tpu_torch.train.checkpoint import CheckpointManager
    from g2vlm_tpu_torch.train.logging import StepTimer, create_logger, format_metrics, maybe_profile
    from g2vlm_tpu_torch.weights import (SEGFORMER_PREFIX, absent_optional, build_model, init_moe_from_dense,
                                         load_checkpoint, load_safetensors, load_segformer_pth)

    world, rank, device, made_group = init_distributed(args)
    logger = create_logger(rank=rank)
    if world % (args.dp * args.tp):
        raise ValueError(f"--dp {args.dp} x --tp {args.tp} does not divide the world of {world} processes")
    fsdp = world // (args.dp * args.tp)
    dp_rank = rank // (fsdp * args.tp)  # the mesh's ranks run (dp, fsdp, tp), tp fastest
    if world > 1:
        logger.info(f"mesh: dp={args.dp} fsdp={fsdp} tp={args.tp} over {world} processes")
    tokenizer = new_token_ids = None
    segformer_from_checkpoint = False
    if args.model_path:
        from g2vlm_tpu_torch.data.tokenizer import load_tokenizer

        # the checkpoint's config, whatever --tiny says, as train.py takes it; with --train_conf the conf
        # decoder and head and the SegFormer it lacks are drawn from seed + 7, as train.py draws them
        ckpt_cfg = dataclasses.replace(G2VLMConfig.from_checkpoint_dir(args.model_path),
                                       train_conf_pi3=args.train_conf)
        model, cfg = load_checkpoint(args.model_path, device=device, dtype=torch.float32, cfg=ckpt_cfg,
                                     seed=args.seed + 7)
        segformer_from_checkpoint = args.train_conf and SEGFORMER_PREFIX not in absent_optional(
            load_safetensors(os.path.join(args.model_path, "model.safetensors")), cfg)
        if args.bootstrap_moe:
            init_moe_from_dense(model)
            logger.info(f"--bootstrap_moe: geo expert copied from the base expert ({cfg.llm.layer_module} layers)")
        tokenizer, new_token_ids, _ = load_tokenizer(args.model_path)
        logger.info(f"checkpoint {args.model_path}: vocabulary of {len(tokenizer)}, special ids {new_token_ids}")
    else:
        cfg = tiny_test_config() if args.tiny else G2VLMConfig(visual_und=args.max_vit_patches > 0)
        if args.cut_depth:
            cfg = cut_depth_config(cfg, args.cut_depth)
        cfg = dataclasses.replace(cfg, train_conf_pi3=args.train_conf)
        model = build_model(cfg, device=device, dtype=torch.float32, seed=args.seed)
        if args.tokenizer_path:
            from g2vlm_tpu_torch.data.tokenizer import load_tokenizer

            tokenizer, new_token_ids, _ = load_tokenizer(args.tokenizer_path)
            if len(tokenizer) > cfg.llm.vocab_size:
                raise ValueError(f"tokenizer vocabulary {len(tokenizer)} exceeds the model's {cfg.llm.vocab_size}")
    if args.train_conf:
        if args.segformer_pth:
            model.segformer.load_state_dict(load_segformer_pth(args.segformer_pth, device))
            logger.info(f"segformer weights from {args.segformer_pth}")
        elif not segformer_from_checkpoint:
            logger.info("WARNING: no segformer weights (checkpoint or --segformer_pth) — sky supervision uses "
                        "RANDOM weights")
    model.train()
    mesh = sp = None
    if world > 1:
        from g2vlm_tpu_torch.parallel.mesh import FSDP, make_mesh, shard_model

        mesh = make_mesh(world, dp=args.dp, fsdp=fsdp, tp=args.tp, device_type=device.type)
        shard_model(model, mesh)
        if args.sequence_parallel and fsdp > 1:
            sp = mesh[FSDP].get_group()
    if args.sequence_parallel and sp is None:
        logger.info("--sequence_parallel ignored: fsdp axis is 1")
    schedule = trainer.warmup_cosine_schedule(0.0, args.lr, args.warmup, max(args.steps, args.warmup + 1))
    optimizer = trainer.make_optimizer(
        model, schedule=schedule, weight_decay=args.weight_decay,
        freeze_und=args.freeze_und, freeze_recon=args.freeze_recon,
        mu_dtype=torch.bfloat16 if args.mu_dtype == "bfloat16" else None,
        factored_v=args.factored_v,
    )
    state = trainer.init_train_state(model, optimizer, ema=True)
    n_train = sum(p.numel() for p in optimizer.params)  # global shapes, where sharded
    n_all = sum(p.numel() for p in model.parameters())
    logger.info(f"device {device}; {n_all / 1e9:.3f} B parameters, {n_train / 1e9:.3f} B trainable")
    mgr = CheckpointManager(args.checkpoint_dir, keep=args.keep_ckpts)
    data_status = None
    if args.resume and mgr.latest_step() is not None:
        state, data_status = mgr.restore(state)
        logger.info(f"resumed at step {state.step} from {args.checkpoint_dir}")

    if data_cfg is not None and tokenizer is None and cfg.llm.vocab_size < _HASH_VOCAB:
        raise ValueError(
            f"without --tokenizer_path or --model_path the datasets' text ids are hash(word) % 5000 + 100: with "
            f"the four special tokens above them they need a vocabulary of at least {_HASH_VOCAB}, and this "
            f"model's is {cfg.llm.vocab_size} (pass --tokenizer_path, or --cut_depth for a model of 5,120)")
    if data_cfg is not None:
        # train.py's packer batches have a leading axis of 1 whatever --dp says, so its whole mesh
        # trains on each pack; here every rank draws the same packs from the seeded packer
        if args.dp > 1:
            logger.info(f"--data_config: one pack a step for all {args.dp} dp replicas, as train.py takes it")
        batches = packer_batches(args, data_cfg, cfg, new_token_ids, tokenizer, data_status, device)
    elif args.views is not None:
        batch, geo_start = full_size_batch(cfg, args.views, tuple(args.hw), args.tokens, args.seed + dp_rank, device)
        if not args.split_layout:
            geo_start = None
        batches = ((batch, geo_start, [], {}) for _ in itertools.count())
    else:
        if args.split_layout:
            raise ValueError("--split_layout needs the sorted full-size pack: pass --views")
        batches = ((batch, geo_start, [], {}) for batch, geo_start in synthetic_batches(
            cfg, args.seed, device, start=state.step, dp=args.dp, dp_rank=dp_rank))

    step_fns = {}  # one step function per geo_start, as train.py caches one program per bucket

    def get_step_fn(geo_start):
        if geo_start not in step_fns:
            step_fns[geo_start] = trainer.make_train_step(
                cfg, compute_dtype=torch.float32 if args.tiny else torch.bfloat16,
                ema_decay=args.ema_decay, geo_start=geo_start, head_view_chunk=args.head_view_chunk,
                remat_group=args.remat_group, dino_remat_group=args.dino_remat_group,
                remat_inner=not args.no_inner_remat, sp=sp,
            )
        return step_fns[geo_start]

    # the resume cursors, folded per consumed batch, saved with each checkpoint; the packer's
    # own status (the cursors of the samples it read and dropped, its counters) joins them
    status = dict(data_status or {})
    timer = StepTimer()
    for step, (batch, geo_start, dixs, packer_status) in enumerate(batches, start=state.step):
        if step >= args.steps:
            break
        fold_data_status(status, dixs)
        status.update(packer_status)
        with maybe_profile(args.profile_dir, step, 5, 3):
            state, metrics = get_step_fn(geo_start)(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            if device.type == "cuda":
                torch.cuda.synchronize()
            timer.tick()
            logger.info(format_metrics(step, metrics, timer.avg_step_time))
        if step > 0 and step % args.ckpt_every == 0:
            mgr.save(step, state, data_status=status or None)
            logger.info(f"checkpointed step {step}")
    mgr.save(state.step, state, data_status=status or None)
    mgr.wait()
    logger.info("done")
    if made_group:
        import torch.distributed as dist

        dist.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
