"""The port's multi-GPU layer against g2vlm_tpu's virtual 8-device mesh, on
the CPU: `parallel/mesh.py` (FSDP2 over dp and fsdp, DTensor tensor
parallelism), `parallel/sequence.py`, `generate_tp`, checkpoints of a sharded
state and `train_torch.py --dp / --tp / --sequence_parallel`. The port runs
in gloo process groups spawned once for the module (2 ranks and 4 ranks,
tests/torch_parallel_cases.py), one torch thread each; the JAX side runs
here on the conftest's virtual devices, while the ranks work. Weights and
inputs come from seeds on both sides; fp32 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_cases as tc
from g2vlm_tpu.config import tiny_test_config
from g2vlm_tpu.inference import decoding as jdec
from g2vlm_tpu.models import g2vlm as jg
from g2vlm_tpu.ops.masks import TokenInfo as JTokenInfo
from g2vlm_tpu.parallel import mesh as jmesh
from g2vlm_tpu.parallel.sequence import sequence_parallel_attention as jax_sp_attention
from g2vlm_tpu.train import trainer as jtr
from g2vlm_tpu_torch.inference import decoding
from g2vlm_tpu_torch.ops.attention import segment_attention
from g2vlm_tpu_torch.train.checkpoint import CheckpointManager, state_tensors
from g2vlm_tpu_torch.weights import build_model, state_dict_from_jax

JCFG = tiny_test_config(visual_und=False)


# (dp, fsdp, tp), sequence parallel, phase 10's flags (factored Adam with a bf16 first moment, the und
# expert frozen), SPLIT layout, and whether the step is also held against g2vlm_tpu's on the same mesh
# (each JAX step is a compile of ~15-30 s on the CPU; dp2 and tp2 are held against the one-process port,
# which tests/test_torch_trainer.py holds against the JAX step)
MESHES = [
    ((2, 1, 1), False, False, False, False),
    ((1, 2, 1), True, False, False, True),
    ((1, 1, 2), False, False, True, False),
    ((1, 2, 2), True, True, True, True),
]
MESH_IDS = ["dp2", "fsdp2_sp", "tp2", "fsdp2_tp2_sp_factored_bf16mu_frozen"]
RESUME_FLAGS = ["--tiny", "--synthetic", "--device", "cpu", "--views", "2", "--hw", "56", "56", "--tokens", "128", "--split_layout",
                "--tp", "2", "--sequence_parallel", "--factored_v", "--freeze_und", "--log_every", "1",
                "--ckpt_every", "2"]
STARTS = [int(x) for x in np.random.default_rng(3).integers(3, 100, 8)]


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """The 2- and 4-rank groups, handed every case of the module at once, so
    that they work while the JAX side compiles; each test takes its case's
    results by key."""
    torch.set_num_threads(2)
    made = {n: tc.Pool(n) for n in (2, 4)}
    for n in (2, 4):
        made[n].submit(f"sp{n}", "case_sp_attention", seed=n)
    for (dp, fsdp, tp), sp, flags, sorted_layout, _ in MESHES:
        made[dp * fsdp * tp].submit(f"step{(dp, fsdp, tp)}", "case_train_step", dp=dp, fsdp=fsdp, tp=tp, sp=sp,
                                    factored=flags, freeze_und=flags, sorted_layout=sorted_layout, param_seed=3,
                                    batch_seeds=[11, 12])
    made[4].submit("recon", "case_recon", seed=5, dp=1, fsdp=2, tp=2)
    for n in (2, 4):
        made[n].submit(f"generate_tp{n}", "case_generate_tp", model_seed=0, kv_seed=7)
    made[4].submit("generate_batched_dp", "case_generate_batched_dp", model_seed=0, kv_seed=7, starts=STARTS)
    work = tmp_path_factory.mktemp("resume")
    made[4].dirs = str(work / "a"), str(work / "b")
    made[4].submit("resume_a", "case_train_torch", argv=RESUME_FLAGS + ["--steps", "4", "--checkpoint_dir", made[4].dirs[0]])
    made[4].submit("resume_b0", "case_train_torch", argv=RESUME_FLAGS + ["--steps", "2", "--checkpoint_dir", made[4].dirs[1]])
    made[4].submit("resume_b", "case_train_torch",
                   argv=RESUME_FLAGS + ["--steps", "4", "--checkpoint_dir", made[4].dirs[1], "--resume"])
    yield made
    for pool in made.values():
        pool.close()


def _jax_params(model):
    return jax.tree.map(jnp.asarray, jg.params_from_torch(model.state_dict(), JCFG))


# ---------------------------------------------------------------------------
# sequence-parallel attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_sequence_parallel_attention_matches_jax_and_one_process(pools, n):
    """sequence_parallel_attention over n ranks: out and dq / dk / dv against
    JAX's over a mesh of n devices (1e-5) and the port's one-process
    attention; every rank holds the same global result."""
    arrays, info = tc.sp_inputs(n)
    jinfo = JTokenInfo(*(jnp.asarray(f.numpy()) for f in info))
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("fsdp",))
    q, k, v, dout = (jnp.asarray(arrays[x]) for x in ("q", "k", "v", "dout"))

    @jax.jit  # ~9 s op by op, ~1 s compiled
    def fwd_bwd(q, k, v, dout):
        out, vjp = jax.vjp(lambda a, b, c: jax_sp_attention(a, b, c, jinfo, jinfo, mesh, impl="dense"), q, k, v)
        return out, vjp(dout)

    jout, grads = fwd_bwd(q, k, v, dout)
    want = dict(out=jout, **dict(zip(("dq", "dk", "dv"), grads)))

    tq, tk, tv = (torch.from_numpy(arrays[x]).requires_grad_(True) for x in ("q", "k", "v"))
    one = segment_attention(tq, tk, tv, info, info)
    one.backward(torch.from_numpy(arrays["dout"]))
    ref = dict(out=one, dq=tq.grad, dk=tk.grad, dv=tv.grad)
    got = pools[n].result(f"sp{n}")
    for name in ("out", "dq", "dk", "dv"):
        for r in range(1, n):
            np.testing.assert_array_equal(got[r][name], got[0][name], err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(got[0][name], np.asarray(want[name]), rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(got[0][name], ref[name].detach().numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# training steps on (dp, fsdp, tp) meshes
# ---------------------------------------------------------------------------

def _hold_updates(got, want, before, rel, what):
    """Each leaf's update (after - before) against the reference's, leaf by
    leaf, for the parameters and their EMA. A step moves an entry by at most
    ~lr (lr (1 - decay) for the EMA): every entry within 2 lr of the
    reference's. A leaf the reference moves by a tenth of a step or more
    (RMS) has an RMS difference within `rel` of the reference's RMS update;
    a zeroed, scaled or sign-flipped update fails there. A leaf moved by
    less has no gradient but rounding noise (a key bias under softmax, the
    unused mask token, a translation bias the alignment removes), which
    Adam turns into an update of either sign: it agrees within a tenth of a
    step (RMS). A leaf the reference leaves unchanged stays bitwise."""
    for key, w in want.items():
        if not key.startswith(("params/", "ema/")):
            continue
        b = before[key.split("/", 1)[1]].astype(np.float64)
        lr = tc.LR if key.startswith("params/") else tc.LR * (1 - tc.EMA_DECAY)
        u_got, u_want = got[key] - b, w - b
        rms = np.sqrt(np.mean(u_want ** 2))
        if rms == 0:
            np.testing.assert_array_equal(got[key], w, err_msg=f"{key} against {what}")
            continue
        err = u_got - u_want
        assert np.abs(err).max() <= 2 * lr, (key, what, np.abs(err).max() / lr)
        bound = rel * rms if rms >= 0.1 * lr else 0.1 * lr
        assert np.sqrt(np.mean(err ** 2)) <= bound, (key, what, np.sqrt(np.mean(err ** 2)) / rms)


def _hold_moments(got, want, rel):
    """Each leaf's first moment, (1 - b1) times its clipped gradient after
    one step, against the one-process step's: Adam's update hides the
    gradient's scale, the moment does not (a rank's missing part of a
    gradient fails here). RMS difference within `rel` of the leaf's RMS,
    plus 1e-5 of the whole moment's RMS for the leaves whose gradient is
    rounding noise."""
    mus = {k: w.astype(np.float64) for k, w in want.items() if k.startswith("mu/")}
    floor = 1e-5 * np.sqrt(np.mean(np.concatenate([m.ravel() for m in mus.values()]) ** 2))
    for key, w in mus.items():
        err = np.sqrt(np.mean((got[key] - w) ** 2))
        assert err <= rel * np.sqrt(np.mean(w ** 2)) + floor, (key, err / np.sqrt(np.mean(w ** 2)))


def _jax_step(shape, sp, phase10_flags, sorted_layout):
    """g2vlm_tpu's make_train_step on a (dp, fsdp, tp) mesh of virtual
    devices, from random_model(3), on the packs of seeds 11 (and 12 at dp
    2) stacked on the dp axis: (metrics, the state after the step by the
    port's names)."""
    dp, fsdp, tp = shape
    fields, geo_start = tc.stacked_batch([11, 12][:dp], sorted_layout)
    mesh = jmesh.make_mesh(dp * fsdp * tp, dp=dp, fsdp=fsdp, tp=tp)
    jparams, _ = jmesh.shard_params(_jax_params(tc.random_model(3)), mesh)
    jopt = jtr.make_optimizer(learning_rate=tc.LR, weight_decay=0.05, params=jparams, freeze_und=phase10_flags,
                              factored_v=phase10_flags, mu_dtype=jnp.bfloat16 if phase10_flags else None)
    with mesh:
        jstep = jax.jit(jtr.make_train_step(JCFG, jopt, compute_dtype=jnp.float32, ema_decay=tc.EMA_DECAY,
                                            donate=False, remat=False, geo_start=geo_start,
                                            sp=(mesh, jmesh.FSDP) if sp else None))
        jstate, jm = jstep(jtr.init_train_state(jparams, jopt, ema=True),
                           jtr.TrainBatch(**{k: jnp.asarray(v) for k, v in fields.items()}))
    state = {f"params/{n}": t.numpy() for n, t in state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params), tc.CFG).items()}
    state.update({f"ema/{n}": t.numpy() for n, t in state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.ema_params), tc.CFG).items()})
    return {k: float(v) for k, v in jm.items()}, state


@pytest.mark.parametrize("shape,sp,phase10_flags,sorted_layout,with_jax", MESHES, ids=MESH_IDS)
def test_train_step_matches_jax_mesh_and_one_process(pools, shape, sp, phase10_flags, sorted_layout, with_jax):
    """One step of the sharded port (dp rank i on pack i) against the port's
    one-process step on the same packs and, `with_jax`, g2vlm_tpu's
    make_train_step on the same mesh of virtual devices (the packs
    stacked on the dp axis): loss, details and grad_norm (1e-5 / 1e-3); each
    leaf's first moment against the one-process one (1e-5, 2e-3 in bf16);
    each leaf's update of the parameters and their EMA (`_hold_updates`:
    1e-2 / 5e-2 of the leaf's RMS update: Adam's first step divides each
    gradient entry by its own size, so an entry near eps moves by up to ~lr
    on a last-bit difference in its gradient). Frozen leaves stay bitwise,
    and fsdp halves the parameter bytes a rank holds."""
    dp, fsdp, tp = shape
    seeds = [11, 12][:dp]
    kw = dict(factored=phase10_flags, freeze_und=phase10_flags)
    fields, geo_start = tc.stacked_batch(seeds, sorted_layout)

    state = tc.make_state(3, None, **kw)
    before = {n: p.detach().numpy().copy() for n, p in state.model.named_parameters()}
    step = tc.ttr.make_train_step(tc.CFG, compute_dtype=torch.float32, ema_decay=tc.EMA_DECAY, geo_start=geo_start)
    state, tm = step(state, tc.ttr.TrainBatch.from_numpy(**fields))
    one = {k: t.float().numpy() for k, t in state_tensors(state).items()}
    full_bytes = sum(p.numel() * p.element_size() for p in state.model.parameters())

    ranks = pools[dp * fsdp * tp].result(f"step{shape}")
    got, gm = ranks[0]["state"], ranks[0]["metrics"]
    assert set(gm) == {k for k in tm} and set(got) == set(one)
    for key in gm:
        np.testing.assert_allclose(gm[key], tm[key].item(), rtol=1e-5, atol=1e-7, err_msg=f"{key} one process")
    _hold_moments(got, one, 2e-3 if phase10_flags else 1e-5)  # the bf16 moment rounds near-equal values
    _hold_updates(got, one, before, 1e-2, "one process")
    if with_jax:
        jm, jax_state = _jax_step(shape, sp, phase10_flags, sorted_layout)
        assert set(gm) == set(jm)
        for key in gm:
            if key != "grad_norm" or not kw["freeze_und"]:
                np.testing.assert_allclose(gm[key], jm[key], rtol=1e-3, atol=1e-6, err_msg=f"{key} jax")
        # with frozen leaves g2vlm_tpu's norm also counts their gradients; the port's is the clip's, over
        # the trainable leaves (a difference kept on purpose, ROADMAP C)
        assert gm["grad_norm"] <= jm["grad_norm"] * (1 + 1e-5)
        _hold_updates(got, jax_state, before, 5e-2, "jax")
    for name, p in state.model.named_parameters():
        if not p.requires_grad:
            for kind in ("params", "ema"):
                np.testing.assert_array_equal(got[f"{kind}/{name}"], before[name], err_msg=name)
    held = [r["bytes"] for r in ranks]
    if fsdp == 2 and tp == 1:  # every leaf split in two (one row more on rank 0 where odd)
        assert sum(held) == full_bytes and max(held) <= 0.51 * full_bytes, (held, full_bytes)
    elif tp == 2:  # the decoder's projections and the lm_head split over tp
        assert all(b < full_bytes / fsdp for b in held), (held, full_bytes)


# ---------------------------------------------------------------------------
# recon on a sharded model
# ---------------------------------------------------------------------------

def test_recon_forward_on_a_sharded_model_matches_one_process(pools):
    """recon_from_views with every rank on the same views, on (dp, fsdp,
    tp) = (1, 2, 2): the one-process points at tests/test_multichip.py's
    tolerance, on every rank."""
    model = build_model(tc.tiny_test_config(), device="cpu", seed=5).eval()
    want = tc.recon_pipeline(model).recon_from_views(tc.recon_views(5), prompt="")["points"].numpy()
    for got in pools[4].result("recon"):
        np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# decoding across ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_generate_tp_matches_generate_and_jax(pools, n):
    """The cache's 64 rows split over n ranks, a 23-row prefill spanning
    shards: the tokens and count of one-process `generate` and of JAX
    generate_tp on n virtual devices, exactly, on every rank."""
    lm = build_model(tiny_test_config(), device="cpu", seed=0).language_model
    toks, num, _ = decoding.generate(lm, tc.filled_cache(*tc.decode_inputs(7)), 5, 23, eos_token_id=8,
                                     cfg=tc.CFG.llm, max_new_tokens=8, compute_dtype=torch.float32)
    k, v = tc.decode_inputs(7)
    jcfg = tiny_test_config().llm
    jparams = jax.tree.map(jnp.asarray, jg.params_from_torch(
        build_model(tiny_test_config(), device="cpu", seed=0).state_dict(), tiny_test_config()))["llm"]
    jcache = jdec.fill_cache(jdec.make_cache(jcfg, 64, dtype=jnp.float32), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                             23)
    jtoks, jnum, _ = jdec.generate_tp(jparams, jcache, jnp.asarray(5), jnp.asarray(23), eos_token_id=8, cfg=jcfg,
                                      mesh=jmesh.make_mesh(n, dp=1, fsdp=1, tp=n), axis_name=jmesh.TP,
                                      max_new_tokens=8, compute_dtype=jnp.float32)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert int(num) == int(jnum)
    for got in pools[n].result(f"generate_tp{n}"):
        np.testing.assert_array_equal(got["tokens"], toks.numpy())
        assert got["num"] == int(num)


def test_generate_batched_dp_matches_one_process(pools):
    """Four ranks decode two sequences each of a batch of eight: the
    gathered tokens and counts are one-process generate_batched's."""
    lm = build_model(tiny_test_config(), device="cpu", seed=0).language_model
    toks, num, _ = decoding.generate_batched(lm, tc.filled_cache(*tc.decode_inputs(7), batch=8),
                                             torch.as_tensor(STARTS), torch.full((8,), 23), eos_token_id=8,
                                             cfg=tc.CFG.llm, max_new_tokens=6, compute_dtype=torch.float32)
    for got in pools[4].result("generate_batched_dp"):
        np.testing.assert_array_equal(got["tokens"], toks.numpy())
        np.testing.assert_array_equal(got["num"], num.numpy())


# ---------------------------------------------------------------------------
# train_torch.py on a mesh: checkpoints and --resume
# ---------------------------------------------------------------------------

def test_train_torch_sharded_resume_is_bitwise_and_loads_in_one_process(pools):
    """train_torch.main with --tp 2 --sequence_parallel on 4 ranks (fsdp 2):
    4 steps straight, against 2 steps and then --resume to 4, bitwise (the
    gathered parameters, moments, EMA, counters); the sharded run's
    checkpoint restores into a one-process state bitwise."""
    a, b = pools[4].result("resume_a")[0], pools[4].result("resume_b")[0]
    pools[4].result("resume_b0")
    a_dir = pools[4].dirs[0]
    assert set(a) == set(b) and int(a["step"]) == 4
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)

    model = build_model(tiny_test_config(), device="cpu", seed=0).train()  # --tiny: the ViT too
    opt = tc.ttr.make_optimizer(model, freeze_und=True, factored_v=True)
    state, _ = CheckpointManager(a_dir).restore(tc.ttr.init_train_state(model, opt, ema=True))
    restored = state_tensors(state)
    assert state.step == 4 and set(restored) == set(a)
    for key, t in restored.items():
        np.testing.assert_array_equal(t.numpy(), a[key], err_msg=key)


def test_synthetic_batches_give_dp_rank_i_train_py_row_i():
    """train_torch.py --synthetic --dp 2: dp rank i steps on row i of each of
    train.py's synthetic batches (seed + step * dp + i), field for field."""
    import sys

    sys.path.insert(0, str(tc.REPO))
    try:
        import train
        import train_torch
    finally:
        sys.path.pop(0)
    jcfg = tiny_test_config()
    want = [next(b) for b in [train.synthetic_batches(jcfg, 2, 5)] for _ in range(3)]
    for rank in range(2):
        got = train_torch.synthetic_batches(tc.CFG, 5, "cpu", dp=2, dp_rank=rank)
        for step in range(3):
            batch, _ = next(got)
            for name, a in want[step]._asdict().items():
                if a is not None:
                    np.testing.assert_array_equal(getattr(batch, name)[0].numpy(), np.asarray(a)[rank],
                                                  err_msg=f"{name} rank {rank} step {step}")
