"""The kernel launches that chip_smoke.py states for one training step
(`_step_launches`, which its phases 9 and 10 gate the card's counts on), held
against what the kernels' autograd Functions do on the CPU: each forward call
is one lse-forward launch on the card (K3, K6), each backward call one dq and
one dkv launch (K5, K7). Per-layer checkpointing, groups of layers
checkpointed around it (`remat_group`, `dino_remat_group`) and the Pi3 heads
in view chunks (`head_view_chunk`), with the conf decoder (`train_conf_pi3`:
one more Pi3 decoder), at tiny_test_config size; and the joint
step: a pack with ViT images (each ViT block checkpointed: K3 twice, K5 once),
with the recon side frozen (`--freeze_recon`: DINOv2 runs the plain forward
K1, no backward; the frozen Pi3 heads keep K6 / K7) or all of it trained.
CPU only."""

import collections
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import train_torch  # noqa: E402
from g2vlm_tpu_torch.config import tiny_test_config  # noqa: E402
from g2vlm_tpu_torch.ops import flash_attention as fa  # noqa: E402
from g2vlm_tpu_torch.train import trainer  # noqa: E402
from g2vlm_tpu_torch.weights import build_model  # noqa: E402

# (layers of the decoder and of DINOv2, train_forward's options, _step_launches' options, config fields);
# two views
CASES = {
    "per_layer_2": (2, {}, {}, {}),
    "remat_group_2_of_2": (2, dict(remat_group=2, dino_remat_group=2), dict(remat_group=2, dino_remat_group=2), {}),
    "remat_group_2_of_4": (4, dict(remat_group=2, dino_remat_group=2), dict(remat_group=2, dino_remat_group=2), {}),
    "remat_group_4_of_4": (4, dict(remat_group=4, dino_remat_group=4), dict(remat_group=4, dino_remat_group=4), {}),
    "llm_group_only": (4, dict(remat_group=2), dict(remat_group=2), {}),
    "head_view_chunk_1": (2, dict(head_view_chunk=1), dict(chunks=2), {}),
    "conf_head": (2, {}, {}, dict(train_conf_pi3=True)),
    "conf_head_view_chunk_1": (2, dict(head_view_chunk=1), dict(chunks=2), dict(train_conf_pi3=True)),
}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """This module runs many small torch ops, which torch spreads over one thread per core by
    default; beside the other test workers that oversubscribes the machine (1.7x slower on one
    core), so the module runs on two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _counted_calls(monkeypatch):
    """Launches the card would make, counted from the autograd Functions' calls on the CPU."""
    counts = collections.Counter()
    for cls, form in ((fa._SegmentAttention, "segment"), (fa._BatchedAttention, "batched")):
        def forward(ctx, *args, _f=cls.forward, _form=form):
            counts[f"flash_{_form}_attention_lse"] += 1
            return _f(ctx, *args)

        def backward(ctx, *args, _b=cls.backward, _form=form):
            counts[f"flash_{_form}_attention_bwd_dq"] += 1
            counts[f"flash_{_form}_attention_bwd_dkv"] += 1
            return _b(ctx, *args)

        monkeypatch.setattr(cls, "forward", staticmethod(forward))
        monkeypatch.setattr(cls, "backward", staticmethod(backward))
    return counts


@pytest.mark.parametrize("name", list(CASES))
def test_step_launches_equal_the_calls_of_a_step(name, monkeypatch):
    layers, kw, launch_kw, top = CASES[name]
    base = tiny_test_config()
    cfg = dataclasses.replace(base, llm=dataclasses.replace(base.llm, num_hidden_layers=layers),
                              dino=dataclasses.replace(base.dino, num_hidden_layers=layers), **top)
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=0).train()
    trainer.apply_freeze(model, freeze_und=True)
    # the SegFormer's quarter-size map must hold its first 8x8 spatial-reduction conv
    hw, rows = ((56, 70), 96) if cfg.train_conf_pi3 else ((28, 42), 64)
    batch, geo_start = train_torch.full_size_batch(cfg, 2, hw, rows, 0, "cpu")
    counts = _counted_calls(monkeypatch)
    loss, _ = trainer.train_forward(model, batch.map(lambda x: x[0]), cfg, compute_dtype=torch.float32,
                                    geo_start=geo_start, **kw)
    loss.backward()
    assert torch.isfinite(loss)
    assert dict(counts) == chip_smoke._step_launches(cfg, **launch_kw)


@pytest.mark.parametrize("freeze_recon", [True, False], ids=["freeze_recon", "all_trained"])
@pytest.mark.parametrize("sorted_layout", [True, False], ids=["split", "mixed"])
def test_joint_step_launches_equal_the_calls_of_a_step(freeze_recon, sorted_layout, monkeypatch):
    from test_torch_joint_train import _pack

    cfg = tiny_test_config()
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=0).train()
    trainer.apply_freeze(model, freeze_recon=freeze_recon)
    fields, geo_start = _pack(sorted_layout)
    counts = _counted_calls(monkeypatch)
    plain_forwards = collections.Counter()
    batched = fa.flash_batched_attention_reference

    def counted_plain(*args, **kw):  # the no-grad CPU path of K1, which the card runs as the kernel
        plain_forwards["flash_batched_attention"] += 1
        return batched(*args, **kw)

    monkeypatch.setattr(fa, "flash_batched_attention_reference", counted_plain)
    loss, _ = trainer.train_forward(model, trainer.TrainBatch.from_numpy(**fields), cfg,
                                    compute_dtype=torch.float32, geo_start=geo_start)
    loss.backward()
    assert torch.isfinite(loss)
    want = chip_smoke._step_launches(cfg, vit=True, freeze_recon=freeze_recon)
    assert {**counts, **plain_forwards} == want
