"""Checkpoints of the port's training state (g2vlm_tpu_torch/train/checkpoint.py)
on the CPU: a save / restore round trip is bitwise (parameters, the first
moment in fp32 and bf16, the second moment whole and factored, the count,
the EMA, the step, data_status), the newest `keep` checkpoints stay, a state
that does not fit the file is refused; and `train_torch.main` resumed with
`--resume` runs bit for bit as an uninterrupted run, on synthetic packs and
on a `--data_config` run with the ViT branch (tiny config, the bpe_fixture
vocabulary, so no text goes through Python's salted `hash`)."""

import json
import os
import sys
from pathlib import Path

import pytest
import torch
import yaml

from g2vlm_tpu_torch.config import tiny_test_config
from g2vlm_tpu_torch.data.synthetic import make_tiny_joint_data
from g2vlm_tpu_torch.train import trainer
from g2vlm_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager, state_tensors
from g2vlm_tpu_torch.weights import build_model, load_safetensors

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import train_torch  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """This module runs many small torch ops, which torch spreads over one thread per core by
    default; beside the other test workers that oversubscribes the machine (1.7x slower on one
    core), so the module runs on two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _state(seed, **opt):
    model = build_model(tiny_test_config(), device="cpu", seed=seed).train()
    return trainer.init_train_state(model, trainer.make_optimizer(model, **opt), ema=True)


def _stepped(state, seed=0):
    """Two steps on random gradients, so that every slot of the state holds its own values."""
    g = torch.Generator().manual_seed(seed)
    for _ in range(2):
        for p in state.optimizer.params:
            p.grad = torch.randn(p.shape, generator=g)
        state.optimizer.step()
        for name, p in state.model.named_parameters():
            state.ema_params[name].mul_(0.9).add_(p.detach(), alpha=0.1)
        state.step += 1
    return state


@pytest.mark.parametrize("opt", [dict(), dict(factored_v=True, mu_dtype=torch.bfloat16),
                                 dict(freeze_recon=True, factored_v=True), dict(freeze_und=True,
                                                                                mu_dtype=torch.bfloat16)],
                         ids=["adamw", "factored_bf16", "freeze_recon_factored", "freeze_und_bf16"])
def test_save_restore_round_trip_is_bitwise(tmp_path, opt):
    saved = _stepped(_state(0, **opt))
    status = {"tiny_scenes": {"0": 3}, "_packer": {"step_counter": 4, "group_rng": None}}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(saved.step, saved, data_status=status)
    assert mgr.latest_step() == 2 and sorted(os.listdir(tmp_path)) == ["2", "data_status_2.json"]
    want = {k: v.clone() for k, v in state_tensors(saved).items()}
    assert any(k.startswith("nu_row/") for k in want) == bool(opt.get("factored_v"))
    fresh = _state(1, **opt)
    assert not all(torch.equal(want[k], v) for k, v in state_tensors(fresh).items())
    restored, got_status = mgr.restore(fresh)
    assert got_status == status and restored.step == 2 and restored.optimizer.count == 2
    got = state_tensors(restored)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    # the file holds exactly the state, read back by the port's reader
    assert set(load_safetensors(str(tmp_path / "2" / STATE_FILE))) == set(want)


def test_keep_the_newest_and_refuse_a_state_that_does_not_fit(tmp_path):
    state = _state(0)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    for step in (1, 5, 3, 8):
        mgr.save(step, state, data_status={"a": {"0": step}})
    assert sorted(os.listdir(tmp_path)) == ["5", "8", "data_status_5.json", "data_status_8.json"]
    assert mgr.latest_step() == 8 and mgr.restore(state)[1] == {"a": {"0": 8}}
    mgr.save(9, state)  # without data_status: none written, none read back
    assert mgr.restore(state, 9)[1] is None and not (tmp_path / "data_status_9.json").exists()
    with pytest.raises(KeyError):  # another optimizer: the file's slots do not fit
        mgr.restore(_state(0, factored_v=True))


def _run(argv):
    state = train_torch.main(argv)
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}, state


def _assert_runs_equal(a, b, ckpt_a, ckpt_b):
    (params_a, state_a), (params_b, state_b) = a, b
    assert state_a.step == state_b.step == 4
    for name, p in params_a.items():
        assert torch.equal(p, params_b[name]), name
        assert torch.equal(state_a.ema_params[name], state_b.ema_params[name]), name
    for x, y in zip(state_a.optimizer.mu + [n for nu in state_a.optimizer.nu for n in nu],
                    state_b.optimizer.mu + [n for nu in state_b.optimizer.nu for n in nu]):
        assert torch.equal(x, y)
    status = [ckpt / "data_status_4.json" for ckpt in (ckpt_a, ckpt_b)]
    if status[0].exists():
        assert json.loads(status[0].read_text()) == json.loads(status[1].read_text())
    else:
        assert not status[1].exists()


def test_resumed_synthetic_run_is_bitwise_the_uninterrupted_one(tmp_path):
    common = ["--tiny", "--synthetic", "--device", "cpu", "--log_every", "1", "--ckpt_every", "2",
              "--factored_v", "--mu_dtype", "bfloat16"]
    a = _run(common + ["--steps", "4", "--checkpoint_dir", str(tmp_path / "a")])
    assert sorted(os.listdir(tmp_path / "a")) == ["2", "4"]  # step 2's checkpoint holds 3 steps, as train.py's
    _run(common + ["--steps", "2", "--checkpoint_dir", str(tmp_path / "b")])
    b = _run(common + ["--steps", "4", "--checkpoint_dir", str(tmp_path / "b"), "--resume"])
    _assert_runs_equal(a, b, tmp_path / "a", tmp_path / "b")


def test_resumed_data_config_run_is_bitwise_the_uninterrupted_one(tmp_path):
    from bpe_fixture import train_tiny_bpe

    data_cfg = make_tiny_joint_data(str(tmp_path), target_size=56, vit_hw=(56, 56))
    (tmp_path / "joint.yaml").write_text(yaml.safe_dump(data_cfg))
    (tmp_path / "tok").mkdir()
    train_tiny_bpe(str(tmp_path / "tok"))
    common = ["--tiny", "--device", "cpu", "--data_config", str(tmp_path / "joint.yaml"), "--tokenizer_path",
              str(tmp_path / "tok"), "--max_vit_patches", "512", "--max_num_tokens", "256", "--image_num_range", "2",
              "3", "--split_layout", "--ckpt_every", "2", "--log_every", "1"]
    a = _run(common + ["--steps", "4", "--checkpoint_dir", str(tmp_path / "a")])
    status = json.loads((tmp_path / "a" / "data_status_4.json").read_text())
    assert {"tiny_scenes", "tiny_chats", "_packer"} <= set(status)
    _run(common + ["--steps", "2", "--checkpoint_dir", str(tmp_path / "b")])
    b = _run(common + ["--steps", "4", "--checkpoint_dir", str(tmp_path / "b"), "--resume"])
    _assert_runs_equal(a, b, tmp_path / "a", tmp_path / "b")
    # the same data from the data config's dict: what main calls after load_yaml_config
    c = train_torch.train(train_torch.parse_args(common + ["--steps", "4", "--checkpoint_dir", str(tmp_path / "c")]),
                          data_cfg)
    assert all(torch.equal(p, a[0][n]) for n, p in c.model.named_parameters())


def test_a_tokenizer_less_data_run_needs_a_vocabulary_for_the_hash_ids(tmp_path):
    data_cfg = make_tiny_joint_data(str(tmp_path), n_scenes=1, n_chats=1, target_size=56, vit_hw=(56, 56))
    with pytest.raises(ValueError, match="--tokenizer_path"):
        train_torch.train(train_torch.parse_args(["--tiny", "--device", "cpu", "--data_config", "unread.yaml",
                                                  "--checkpoint_dir", str(tmp_path / "ck")]), data_cfg)


def test_a_data_run_whose_samples_never_fit_a_pack_raises(tmp_path):
    """--max_num_tokens below every sample: the run stops with the limit named
    instead of drawing samples forever."""
    from bpe_fixture import train_tiny_bpe

    data_cfg = make_tiny_joint_data(str(tmp_path), n_scenes=1, n_chats=1, target_size=56, vit_hw=(56, 56))
    (tmp_path / "tok").mkdir()
    train_tiny_bpe(str(tmp_path / "tok"))
    args = train_torch.parse_args(["--tiny", "--device", "cpu", "--data_config", "unread.yaml", "--tokenizer_path",
                                   str(tmp_path / "tok"), "--max_vit_patches", "512", "--max_num_tokens", "32",
                                   "--steps", "1", "--checkpoint_dir", str(tmp_path / "ck")])
    with pytest.raises(ValueError, match="too long to pack alone.*--max_num_tokens"):
        train_torch.train(args, data_cfg)
