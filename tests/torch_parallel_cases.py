"""The worker side of tests/test_torch_parallel.py: a pool of gloo processes
on the CPU (one process group, spawned once per test module), and the cases
they run. Imports torch and the port only: the JAX side runs in the pytest
process. Inputs and weights are made from seeds here and there alike; results
come back as numpy arrays."""

from __future__ import annotations

import datetime
import os
import socket
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from g2vlm_tpu_torch.config import tiny_test_config
from g2vlm_tpu_torch.models import g2vlm as tg
from g2vlm_tpu_torch.train import trainer as ttr
from g2vlm_tpu_torch.weights import build_model

REPO = Path(__file__).resolve().parent.parent
CFG = tiny_test_config(visual_und=False)
N, H, W = 2, 56, 70  # two views, a non-square 4x5 patch grid
LR, EMA_DECAY = 1e-4, 0.9


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

def _worker(rank, world, port, tasks, results):
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK="0")
    dist.init_process_group("gloo", rank=rank, world_size=world, timeout=datetime.timedelta(seconds=180))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            key, name, kwargs = task
            try:
                results.put((rank, key, "ok", globals()[name](**kwargs)))
            except Exception:  # reported to the test, which fails with it
                results.put((rank, key, "error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Pool:
    """`world` spawned processes in one gloo group. `submit` hands every rank
    the same case under a key, and the ranks run their cases in the order
    given; `result(key)` returns that case's results in rank order."""

    def __init__(self, world: int):
        import multiprocessing as mp

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_worker, args=(r, world, port, self.tasks[r], self.results), daemon=True)
                      for r in range(world)]
        self.got = {}
        for p in self.procs:
            p.start()

    def submit(self, key: str, name: str, **kwargs) -> None:
        for q in self.tasks:
            q.put((key, name, kwargs))

    def result(self, key: str, timeout: float = 600):
        while len(self.got.get(key, ())) < self.world:
            r, k, status, out = self.results.get(timeout=timeout)
            self.got.setdefault(k, {})[r] = (status, out)
        got = self.got.pop(key)
        errors = [out for status, out in got.values() if status != "ok"]
        if errors:
            raise RuntimeError("a worker failed:\n" + errors[0])
        return [got[r][1] for r in range(self.world)]

    def close(self, timeout: float = 60) -> None:
        """Ends the workers; results nobody took (a test deselected) are
        drained, since a process does not exit before its queued puts are
        read."""
        import queue
        import time

        for q in self.tasks:
            q.put(None)
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in self.procs) and time.monotonic() < deadline:
            try:
                self.results.get(timeout=0.5)
            except queue.Empty:
                pass
        for p in self.procs:
            if p.is_alive():
                p.terminate()
            p.join()


# ---------------------------------------------------------------------------
# inputs and weights, the same in every process
# ---------------------------------------------------------------------------

def random_model(seed: int, cfg=CFG) -> tg.G2VLM:
    """build_model with every leaf perturbed by 0.05 N(0, 1) from a numpy
    seed (biases and the zero-initialised leaves included); the point heads'
    projections scaled by 0.1, so that exp(z) stays O(10)."""
    model = build_model(cfg, device="cpu", seed=seed).train()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.add_(torch.from_numpy((0.05 * rng.standard_normal(tuple(p.shape))).astype(np.float32)))
            if name.endswith("point_head.proj.weight"):
                p.mul_(0.1)
    return model


def batch_fields(seed: int, sorted_layout: bool):
    """One packed sample as numpy fields, and geo_start (None unless sorted):
    two views, positive camera-frame depths, ~90% valid pixels, random rigid
    extrinsics, 64 rows."""
    rng = np.random.default_rng(seed)
    b = tg.SequenceBuilder(11, 12)
    hp, wp = H // 14, W // 14
    if sorted_layout:
        b.add_text([7, 23, 45] + list(rng.integers(20, 400, 5)))
        ce_idx = np.arange(b.curr - 3, b.curr)
        geo_start = b.curr
        b.add_dino_images(N, hp, wp)
    else:
        b.add_text([7, 23, 45])
        b.add_dino_images(N, hp, wp)
        b.add_text(list(rng.integers(20, 400, 5)))
        ce_idx = np.arange(b.curr - 3, b.curr)
        geo_start = None
    pre = b.build(pad_to=64)
    local = rng.standard_normal((N, H, W, 3)).astype(np.float32)
    local[..., 2] = np.abs(local[..., 2]) + 1.5
    extr = np.tile(np.eye(4, dtype=np.float32), (1, N, 1, 1))
    q, _ = np.linalg.qr(rng.standard_normal((N, 3, 3)))
    extr[0, :, :3, :3] = q * np.sign(np.linalg.det(q))[:, None, None]
    extr[0, :, :3, 3] = 0.3 * rng.standard_normal((N, 3))
    world = (np.einsum("nij,nhwj->nhwi", extr[0, :, :3, :3], local) + extr[0, :, None, None, :3, 3])[None]
    fields = dict(
        text_ids=pre.text_ids.astype(np.int32), text_indexes=pre.text_indexes.astype(np.int32),
        dino_indexes=pre.dino_indexes.astype(np.int32), vit_indexes=np.zeros((0,), np.int32),
        is_geo=pre.is_geo, position_ids=pre.position_ids,
        doc_id=pre.doc_id, fn_id=pre.fn_id, noise_id=pre.noise_id, pos=pre.pos,
        ce_indexes=ce_idx.astype(np.int32),
        ce_labels=rng.integers(0, CFG.llm.vocab_size, 3).astype(np.int32),
        ce_weights=np.asarray([1.0, 0.5, 2.0], np.float32),
        dino_images=(0.3 * rng.standard_normal((N, 3, H, W))).astype(np.float32),
        world_points=world.astype(np.float32), point_masks=rng.random((1, N, H, W)) < 0.9,
        extrinsics=extr, normal_batch_mask=np.ones((1,), bool),
    )
    return fields, geo_start


def stacked_batch(seeds, sorted_layout):
    """(numpy fields with a leading axis over `seeds`, geo_start)."""
    packs = [batch_fields(s, sorted_layout) for s in seeds]
    return {k: np.stack([f[k] for f, _ in packs]) for k in packs[0][0]}, packs[0][1]


def sp_inputs(seed: int):
    """tests/test_multichip.py's sequence-parallel case: 256 rows, 4:2 heads
    of 32, two docs in causal / full splits; plus a random output gradient."""
    from g2vlm_tpu_torch.ops.masks import make_token_info

    rng = np.random.default_rng(seed)
    s, h, kvh, d = 256, 4, 2, 32
    arrays = dict(q=rng.standard_normal((s, h, d)), k=rng.standard_normal((s, kvh, d)),
                  v=rng.standard_normal((s, kvh, d)), dout=rng.standard_normal((s, h, d)))
    arrays = {k: a.astype(np.float32) for k, a in arrays.items()}
    info = make_token_info([100, 156], [40, 60, 56, 100], ["causal", "full", "causal", "full"])
    return arrays, info


def decode_inputs(seed: int):
    """The JAX generate_tp test's prefill: random (L, 23, KVH, HD) K / V."""
    rng = np.random.default_rng(seed)
    c = CFG.llm
    shape = (c.num_hidden_layers, 23, c.num_key_value_heads, c.head_dim)
    return rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)


def filled_cache(k, v, batch: int = 0):
    """A capacity-64 fp32 cache holding the 23-row prefill (`batch` > 0: that
    many copies, the batched form)."""
    from g2vlm_tpu_torch.inference import decoding
    from g2vlm_tpu_torch.models.mot_decoder import LayerKV

    def one():
        cache = decoding.make_cache(CFG.llm, 64, dtype=torch.float32, device="cpu")
        kvs = [LayerKV(torch.from_numpy(k[i]), torch.from_numpy(v[i])) for i in range(len(k))]
        return decoding.fill_cache(cache, kvs, 23)

    return one() if batch == 0 else decoding.stack_caches([one() for _ in range(batch)])


def _np(t):
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# cases (every rank runs them; each returns what the test holds)
# ---------------------------------------------------------------------------

def case_sp_attention(seed: int):
    """sequence_parallel_attention over the world group: out and dq, dk, dv."""
    from g2vlm_tpu_torch.parallel.sequence import sequence_parallel_attention

    arrays, info = sp_inputs(seed)
    q, k, v = (torch.from_numpy(arrays[n]).requires_grad_(True) for n in ("q", "k", "v"))
    out = sequence_parallel_attention(q, k, v, info, info, dist.group.WORLD)
    out.backward(torch.from_numpy(arrays["dout"]))
    return dict(out=_np(out), dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad))


def make_state(seed, mesh, factored, freeze_und):
    from g2vlm_tpu_torch.parallel.mesh import shard_model

    model = random_model(seed)
    if mesh is not None:
        shard_model(model, mesh)
    opt = ttr.make_optimizer(model, learning_rate=LR, weight_decay=0.05, freeze_und=freeze_und,
                             factored_v=factored, mu_dtype=torch.bfloat16 if factored else None)
    return ttr.init_train_state(model, opt, ema=True)


def case_train_step(dp: int, fsdp: int, tp: int, sp: bool, factored: bool, freeze_und: bool, sorted_layout: bool,
                    param_seed: int, batch_seeds):
    """One step on a (dp, fsdp, tp) mesh of the world: dp rank i steps on the
    pack of batch_seeds[i]. Rank 0 returns the metrics and the whole state
    after the step (gathered, as a checkpoint saves it); every rank the bytes
    of the parameters it holds."""
    from g2vlm_tpu_torch.parallel.mesh import FSDP, addressable_param_bytes, make_mesh
    from g2vlm_tpu_torch.train.checkpoint import state_tensors

    mesh = make_mesh(dist.get_world_size(), dp=dp, fsdp=fsdp, tp=tp, device_type="cpu")
    state = make_state(param_seed, mesh, factored, freeze_und)
    fields, geo_start = batch_fields(batch_seeds[dist.get_rank() // (fsdp * tp)], sorted_layout)
    batch = ttr.TrainBatch.from_numpy(**{k: v[None] for k, v in fields.items()})
    step = ttr.make_train_step(CFG, compute_dtype=torch.float32, ema_decay=EMA_DECAY, geo_start=geo_start,
                               sp=mesh[FSDP].get_group() if sp else None)
    state, metrics = step(state, batch)
    full = state_tensors(state)
    out = dict(bytes=addressable_param_bytes(state.model))
    if dist.get_rank() == 0:
        out.update(metrics={k: v.item() for k, v in metrics.items()},
                   state={k: t.float().numpy() for k, t in full.items()})
    return out


def case_recon(seed: int, dp: int, fsdp: int, tp: int):
    """G2VLMPipeline.recon_from_views on a sharded model, the same views on
    every rank: every rank's points."""
    from g2vlm_tpu_torch.parallel.mesh import make_mesh, shard_model

    cfg = tiny_test_config()
    model = build_model(cfg, device="cpu", seed=seed).eval()
    shard_model(model, make_mesh(dist.get_world_size(), dp=dp, fsdp=fsdp, tp=tp, device_type="cpu"))
    return _np(recon_pipeline(model).recon_from_views(recon_views(seed), prompt="")["points"])


def recon_pipeline(model):
    """A tiny model's pipeline: special tokens inside its vocabulary of 512."""
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline

    ids = dict(bos_token_id=7, eos_token_id=8, start_of_image=11, end_of_image=12)
    return G2VLMPipeline(model, tiny_test_config(), new_token_ids=ids, seq_pad_multiple=32)


def recon_views(seed: int):
    return np.random.default_rng(seed).random((2, 3, 56, 56)).astype(np.float32)


def case_generate_tp(model_seed: int, kv_seed: int):
    """generate_tp over the world group on this rank's context shard."""
    from g2vlm_tpu_torch.inference import decoding

    lm = build_model(tiny_test_config(), device="cpu", seed=model_seed).language_model
    shard = decoding.shard_cache(filled_cache(*decode_inputs(kv_seed)), dist.group.WORLD)
    toks, n, _ = decoding.generate_tp(lm, shard, 5, 23, eos_token_id=8, cfg=CFG.llm, group=dist.group.WORLD,
                                      max_new_tokens=8, compute_dtype=torch.float32)
    return dict(tokens=toks.numpy(), num=int(n))


def case_generate_batched_dp(model_seed: int, kv_seed: int, starts):
    """generate_batched_dp: this rank decodes its slice of the batch."""
    from g2vlm_tpu_torch.inference import decoding

    lm = build_model(tiny_test_config(), device="cpu", seed=model_seed).language_model
    n, r = dist.get_world_size(), dist.get_rank()
    b = len(starts) // n
    caches = filled_cache(*decode_inputs(kv_seed), batch=b)
    mine = torch.as_tensor(starts[r * b:(r + 1) * b])
    toks, num, _ = decoding.generate_batched_dp(lm, caches, mine, torch.full((b,), 23), eos_token_id=8, cfg=CFG.llm,
                                                group=dist.group.WORLD, max_new_tokens=6,
                                                compute_dtype=torch.float32)
    return dict(tokens=toks.numpy(), num=num.numpy())


def case_train_torch(argv):
    """train_torch.main(argv) in the world's group; rank 0 returns the final
    state, gathered."""
    import train_torch
    from g2vlm_tpu_torch.train.checkpoint import state_tensors

    state = train_torch.train(train_torch.parse_args(argv))
    full = state_tensors(state)
    return {k: t.numpy() for k, t in full.items()} if dist.get_rank() == 0 else None
