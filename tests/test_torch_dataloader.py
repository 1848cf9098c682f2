"""The port's prefetching loaders on the CPU, case for case as the JAX
package's tests hold its own (tests/test_data_pipeline.py): the thread loader
over datasets, errors passed on to the consumer, the end-of-stream sentinel,
the `spawn` process loader with numpy trees crossing its queue in each
worker's order; a one-worker thread loader over the port's packer, whose
packs equal the inline packs in order, array for array; and the port's
workers ending at close() beside a full queue, where the JAX thread worker
blocks for good."""

import multiprocessing
import random
import threading
import time

import numpy as np
import pytest

from g2vlm_tpu.train import dataloader as jdl
from g2vlm_tpu_torch.data import packing as tpack
from g2vlm_tpu_torch.data import registry as treg
from g2vlm_tpu_torch.data.recon_dataset import JsonlReconDataset
from g2vlm_tpu_torch.data.synthetic import make_joint_train_data, make_tiny_scene_jsonl
from g2vlm_tpu_torch.train.dataloader import PrefetchLoader, ProcessPrefetchLoader
from test_torch_data_path import assert_same

TOKEN_IDS = dict(bos_token_id=5100, eos_token_id=5101, start_of_image=5102, end_of_image=5103)


@pytest.fixture(scope="module")
def scene_jsonl(tmp_path_factory):
    return make_tiny_scene_jsonl(str(tmp_path_factory.mktemp("scene")), n_frames=4, hw=(84, 140))


def _dataset(path, worker_id=0):
    ds = JsonlReconDataset("scenes", [path], img_size=56, worker_id=worker_id)
    ds.set_random_image_num(2)
    return ds


def test_prefetch_loader(scene_jsonl):
    loader = PrefetchLoader(lambda wid: iter(_dataset(scene_jsonl, wid)), num_workers=2, prefetch=2)
    it = iter(loader)
    samples = [next(it) for _ in range(4)]
    assert all(s["num_tokens"] > 0 for s in samples)
    loader.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_prefetch_loader_propagates_errors_and_ends_finite_streams(pkg):
    """A worker's exception reaches the consumer; a finite stream ends with its last item."""
    cls = PrefetchLoader if pkg == "port" else jdl.PrefetchLoader

    def boom(worker_id):
        raise RuntimeError("boom")
        yield  # pragma: no cover

    loader = cls(boom, num_workers=1)
    with pytest.raises(RuntimeError, match="boom"):
        next(iter(loader))
    loader.close()
    loader = cls(lambda wid: iter(range(wid * 10, wid * 10 + 3)), num_workers=2, prefetch=1)
    assert sorted(loader) == [0, 1, 2, 10, 11, 12]


def _proc_iter(worker_id):
    # module-level so the spawn context can pickle it
    for i in range(3):
        yield {"wid": worker_id, "i": i, "arr": np.full((4,), worker_id)}


def _proc_boom(worker_id):
    raise RuntimeError("proc boom")
    yield  # pragma: no cover


def _endless(worker_id):
    i = 0
    while True:
        yield {"i": i, "arr": np.full((4,), i)}
        i += 1


@pytest.mark.parametrize("kind", ["thread", "process_worker"])
def test_close_ends_the_workers_beside_a_full_queue(kind):
    """close() on an endless stream while the queue is full: the port's worker ends once its current item
    is built, and the thread loader's queue is left empty; the JAX thread worker stays blocked in the
    put of its end sentinel. The process loader's worker runs in a thread here, on a spawn-context
    queue, so that no process is started."""
    if kind == "thread":
        loader = PrefetchLoader(_endless, num_workers=1, prefetch=1)
        assert next(iter(loader))["i"] == 0
        time.sleep(0.2)  # the worker fills the queue, then waits to put the next item
        loader.close()
        assert not any(t.is_alive() for t in loader._threads) and loader.queue.empty()
        jloader = jdl.PrefetchLoader(_endless, num_workers=1, prefetch=1)
        assert next(iter(jloader))["i"] == 0
        time.sleep(0.2)
        jloader.close()
        time.sleep(1.5)
        assert all(t.is_alive() for t in jloader._threads)  # a daemon thread, blocked for good
    else:
        ctx = multiprocessing.get_context("spawn")
        q, stop = ctx.Queue(maxsize=1), ctx.Event()
        worker = threading.Thread(target=ProcessPrefetchLoader._worker, args=(_endless, None, 0, q, stop),
                                  daemon=True)
        worker.start()
        assert q.get(timeout=30)["i"] == 0
        time.sleep(0.2)
        stop.set()
        worker.join(10)
        assert not worker.is_alive()


def test_process_prefetch_loader():
    loader = ProcessPrefetchLoader(_proc_iter, num_workers=2, prefetch=4)
    items = list(loader)
    assert len(items) == 6  # 2 workers x 3 items, none lost
    by_wid = {}
    for it in items:
        by_wid.setdefault(it["wid"], []).append(it["i"])
        assert (it["arr"] == it["wid"]).all()  # numpy round-trips intact
    assert sorted(by_wid) == [0, 1]
    assert all(v == sorted(v) for v in by_wid.values())  # each worker's order kept
    loader.close()


def test_process_prefetch_loader_propagates_errors():
    loader = ProcessPrefetchLoader(_proc_boom, num_workers=1)
    with pytest.raises(RuntimeError, match="proc boom"):
        next(iter(loader))
    loader.close()


def test_one_worker_loader_over_the_packer_gives_the_inline_packs(tmp_path):
    """The three groups of joint_train.yaml packed inline and through a one-worker PrefetchLoader
    (the packer built inside the worker): the same packs in the same order, array for array, and the
    same resume status after them."""
    cfg = make_joint_train_data(str(tmp_path), target_size=56, vit_hw=(56, 56), frames_per_video=2)

    def make_packed():
        groups = treg.build_groups_from_config(cfg)
        for g in groups:
            if g["name"] == "recon_then_und":
                g["dataset"].vit_target_hw = (56, 56)
        pc = tpack.PackerConfig(expected_num_tokens=300, max_num_tokens=512, max_num_tokens_per_sample=256,
                                image_num_range=(2, 3), max_vit_patches=512, sorted_layout=True,
                                geo_start_bucket=16, max_ce_slots=128)
        return tpack.PackedIterableDataset(groups, TOKEN_IDS, pc, group_rng=random.Random(3))

    def with_status(packed):
        for b in packed:
            yield b, packed.resume_status()

    inline = with_status(make_packed())
    want = [next(inline) for _ in range(4)]
    loader = PrefetchLoader(lambda wid: with_status(make_packed()), num_workers=1, prefetch=2)
    it = iter(loader)
    got = [next(it) for _ in range(4)]
    loader.close()
    assert_same(got, want)
