"""The port's training data path against the JAX package's numpy one, exactly,
on the same files and seeds: rank / worker sharding, cropping and frame
ranking, `JsonlReconDataset`, `JsonlVlmDataset`, `SequencePacker.to_batch`
(MIXED and sorted, with and without ViT slots), `PackedIterableDataset`,
`fold_data_status` and the registry's YAML glue; and the port's additions:
a packer stream resumed from its status continues the uninterrupted one. The
scenes and PNGs are written by the port's `make_tiny_joint_data`. CPU only."""

import json
import random
import sys

import numpy as np
import pytest
import yaml
from PIL import Image

from g2vlm_tpu.data import cropping as jcrop
from g2vlm_tpu.data import distributed as jdist
from g2vlm_tpu.data import frame_sampling as jframes
from g2vlm_tpu.data import packing as jpack
from g2vlm_tpu.data import recon_dataset as jrecon
from g2vlm_tpu.data import registry as jreg
from g2vlm_tpu.data import vlm_dataset as jvlm
from g2vlm_tpu_torch.data import cropping as tcrop
from g2vlm_tpu_torch.data import distributed as tdist
from g2vlm_tpu_torch.data import frame_sampling as tframes
from g2vlm_tpu_torch.data import packing as tpack
from g2vlm_tpu_torch.data import recon_dataset as trecon
from g2vlm_tpu_torch.data import registry as treg
from g2vlm_tpu_torch.data import vlm_dataset as tvlm
from g2vlm_tpu_torch.data.synthetic import make_tiny_joint_data

TOKEN_IDS = dict(bos_token_id=500, eos_token_id=501, start_of_image=502, end_of_image=503)


def assert_same(got, want, path="batch"):
    """Equal structure, types and values, arrays bitwise with their dtypes."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three synthetic scenes at a 56-wide target and four image conversations."""
    root = tmp_path_factory.mktemp("joint")
    cfg = make_tiny_joint_data(str(root), n_scenes=3, n_frames=5, n_chats=4, target_size=56, vit_hw=(56, 56))
    return root, cfg


@pytest.mark.parametrize("world_size,num_workers", [(1, 1), (2, 1), (2, 2), (3, 2)])
def test_rank_and_worker_sharding_match(world_size, num_workers):
    rows = [(f"row {i}", f"file_{i % 3}.jsonl") for i in range(23)]
    for rank in range(world_size):
        for worker in range(num_workers):
            kw = dict(local_rank=rank, world_size=world_size, num_workers=num_workers, worker_id=worker,
                      data_status={"0": 4, 1: 7})
            j, t = jdist.DistributedIterable("ds", **kw), tdist.DistributedIterable("ds", **kw)
            for d in (j, t):
                d.data_paths = list(rows)
                d.set_epoch(5)
            assert t.get_data_paths_per_worker() == j.get_data_paths_per_worker()
            assert t.status_for_worker(worker) == j.status_for_worker(worker)
    for status in ([3, 9], None, {"2": 1}):
        j, t = jdist.DistributedIterable("ds", data_status=status), tdist.DistributedIterable("ds", data_status=status)
        assert [t.status_for_worker(w) for w in range(3)] == [j.status_for_worker(w) for w in range(3)]


@pytest.mark.parametrize("aug_crop,aug_focal", [(0, 0.0), (16, 0.0), (0, 0.5), (9, 0.3)])
def test_crop_resize_with_intrinsics_and_frame_ranking_match(rng, aug_crop, aug_focal):
    img = Image.fromarray(rng.integers(0, 256, (90, 150, 3), dtype=np.uint8))
    depth = rng.random((90, 150)).astype(np.float32) + 1.0
    k = np.asarray([[120.0, 0, 74.0], [0, 118.0, 46.0], [0, 0, 1]], np.float32)
    for res in ((56, 42), (140, 98), (518, 294)):
        got = tcrop.crop_resize_with_intrinsics(img, depth, k, res, aug_crop, aug_focal, np.random.default_rng(3))
        want = jcrop.crop_resize_with_intrinsics(img, depth, k, res, aug_crop, aug_focal, np.random.default_rng(3))
        assert_same([np.asarray(got[0]), got[1], got[2]], [np.asarray(want[0]), want[1], want[2]])
    np.testing.assert_array_equal(tcrop.nearest_resize(depth, (61, 33)), jcrop.nearest_resize(depth, (61, 33)))
    q, _ = np.linalg.qr(rng.standard_normal((7, 3, 3)))
    extr = np.tile(np.eye(4, dtype=np.float32), (7, 1, 1))
    extr[:, :3, :3], extr[:, :3, 3] = q, rng.standard_normal((7, 3))
    assert_same(list(tframes.compute_ranking(extr)), list(jframes.compute_ranking(extr)))


def _recon_pair(cfg, **kw):
    path = cfg["recon"]["dataset_info"]["tiny_scenes"]["jsonl_path"]
    return (trecon.JsonlReconDataset("scenes", [path], img_size=56, **kw),
            jrecon.JsonlReconDataset("scenes", [path], img_size=56, **kw))


@pytest.mark.parametrize("sampling", ["nearby", "stratified", "pose_rank"])
def test_recon_dataset_samples_match(data, sampling):
    _, cfg = data
    for kw in (dict(sampling=sampling), dict(sampling=sampling, aug_crop=8, aug_focal=0.4, data_status={0: 0})):
        t, j = _recon_pair(cfg, **kw)
        ti, ji = iter(t), iter(j)
        for i, (n, ar) in enumerate(((3, 0.5), (7, 1.0), (2, 0.75), (4, 1.2))):  # 7 > the 5 frames of a scene
            for d in (t, j):
                d.set_random_image_num(n)
                d.set_random_aspect_ratio(ar)
                d.set_step_rng(100 + i)
            assert_same(next(ti), next(ji), f"{sampling} sample {i}")


def test_vlm_dataset_samples_match_and_a_video_row_raises(data, tmp_path):
    root, cfg = data
    info = cfg["vlm_sft"]["dataset_info"]["tiny_chats"]
    for status in (None, {0: 1}):
        t = tvlm.JsonlVlmDataset("chats", [info["jsonl_path"]], image_root=info["data_dir"], target_hw=(56, 56),
                                 data_status=status)
        j = jvlm.JsonlVlmDataset("chats", [info["jsonl_path"]], image_root=info["data_dir"], target_hw=(56, 56),
                                 data_status=status)
        ti, ji = iter(t), iter(j)
        for i in range(6):  # past the end of the four rows: the walk starts over
            assert_same(next(ti), next(ji), f"sample {i}")
    conv = [{"from": "human", "value": "<image> a <image>"}, {"from": "gpt", "value": "b"}]
    assert_same(tvlm.conversations_to_elements(conv), jvlm.conversations_to_elements(conv))
    # a video row: a folder of 20 frames, of which the row's three <image> tags take three of the
    # eight sampled (one random frame per bin, from the global generator, seeded alike)
    rng = np.random.default_rng(0)
    (tmp_path / "clip").mkdir()
    for i in range(20):
        Image.fromarray(rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)).save(tmp_path / "clip" / f"{i:03d}.png")
    video = tmp_path / "video.jsonl"
    conv = [{"from": "human", "value": "<image><image><image> Where next?"}, {"from": "gpt", "value": "Left."}]
    video.write_text(json.dumps({"video": "clip", "conversations": conv}) + "\n")
    samples = []
    for mod in (tvlm, jvlm):
        random.seed(5)
        samples.append(next(iter(mod.JsonlVlmDataset("videos", [str(video)], image_root=str(tmp_path),
                                                       target_hw=(56, 56)))))
    assert_same(*samples)
    assert len(samples[0]["vit_views"]) == 3


def _samples(cfg, n_vlm):
    """A recon sample and `n_vlm` image conversations, from the JAX datasets."""
    _, j = _recon_pair(cfg)
    j.set_random_image_num(3)
    j.set_random_aspect_ratio(0.75)
    j.set_step_rng(7)
    info = cfg["vlm_sft"]["dataset_info"]["tiny_chats"]
    vlm = iter(jvlm.JsonlVlmDataset("chats", [info["jsonl_path"]], image_root=info["data_dir"], target_hw=(56, 56)))
    return [next(iter(j))] + [next(vlm) for _ in range(n_vlm)]


@pytest.mark.parametrize("sorted_layout", [False, True], ids=["mixed", "sorted"])
@pytest.mark.parametrize("n_vlm,max_vit", [(0, 0), (2, 0), (2, 96), (0, 64)], ids=["recon", "vit_unpadded",
                                                                                    "vit_slots", "empty_vit_slots"])
def test_sequence_packer_to_batch_matches(data, sorted_layout, n_vlm, max_vit):
    _, cfg = data
    samples = _samples(cfg, n_vlm)
    batches = []
    for pack in (tpack, jpack):
        packer = pack.SequencePacker(pack.PackerConfig(max_num_tokens=320, max_ce_slots=64, max_vit_patches=max_vit),
                                     TOKEN_IDS)
        rng = random.Random(4)
        for s in samples:
            packer.add_sample(s, rng)
        batches.append(packer.to_batch(rng, sorted_layout=sorted_layout, geo_start_bucket=16))
    got, want = batches
    assert_same(got, want)
    if max_vit:  # padded ViT slots point past the sequence
        assert (got["vit_indexes"] == 320).sum() == max_vit // 4 - 4 * n_vlm
    for k, v in (("len2weight", [tpack.len2weight(x, r) for x in (0, 1, 9) for r in ("token", "sample", "square")]),):
        assert v == [jpack.len2weight(x, r) for x in (0, 1, 9) for r in ("token", "sample", "square")], k


def _groups(pkg, cfg, status=None):
    return pkg.build_groups_from_config(cfg, data_status=status)


def _packer_cfg(pack):
    return pack.PackerConfig(expected_num_tokens=150, max_num_tokens=256, max_num_tokens_per_sample=200,
                             image_num_range=(2, 3), max_vit_patches=512, sorted_layout=True, geo_start_bucket=16,
                             max_ce_slots=128)


def test_packed_iterable_dataset_matches_and_resumes_exactly(data):
    _, cfg = data

    def take(packed, n):
        it = iter(packed)
        return [next(it) for _ in range(n)]

    random.seed(11)  # the JAX package draws each sample's group from the global generator
    want = take(jpack.PackedIterableDataset(_groups(jreg, cfg), TOKEN_IDS, _packer_cfg(jpack)), 5)
    assert {len(b["vit_patches"]) for b in want} == {512} and any((b["vit_seg"] >= 0).any() for b in want)
    # the port draws from a generator of its own: the same draws as the global one seeded alike
    packed = tpack.PackedIterableDataset(_groups(treg, cfg), TOKEN_IDS, _packer_cfg(tpack),
                                         group_rng=random.Random(11))
    it = iter(packed)
    got = [next(it) for _ in range(2)]
    status = json.loads(json.dumps(packed.resume_status()))  # as a checkpoint writes and reads it
    got += [next(it) for _ in range(3)]
    assert_same(got, want)
    # resumed from the status after pack 2: datasets fast-forwarded, the packer's counters restored
    resumed = tpack.PackedIterableDataset(_groups(treg, cfg, status), TOKEN_IDS, _packer_cfg(tpack),
                                          group_rng=random.Random(0), resume=status)
    assert_same(take(resumed, 3), want[2:])
    assert status[tpack.PACKER_STATUS]["step_counter"] > 0


@pytest.mark.parametrize("mandatory", [True, False], ids=["mandatory", "drawn"])
def test_packed_iterable_dataset_raises_when_no_sample_fits(data, mandatory):
    """Samples all too long to pack alone: the port raises, naming the limit,
    where the JAX packer would draw forever."""
    _, cfg = data
    groups = [g for g in _groups(treg, cfg) if g["name"] == "recon"]
    groups[0]["is_mandatory"] = mandatory
    packer_cfg = tpack.PackerConfig(expected_num_tokens=150, max_num_tokens=256, max_num_tokens_per_sample=8,
                                    image_num_range=(2, 3))
    packed = tpack.PackedIterableDataset(groups, TOKEN_IDS, packer_cfg, group_rng=random.Random(0))
    with pytest.raises(ValueError, match="max_num_tokens_per_sample 8.*--max_num_tokens"):
        next(iter(packed))
    assert packed.too_long_in_a_row == tpack.MAX_TOO_LONG_IN_A_ROW


@pytest.mark.parametrize("cap", [48, 64])
def test_packed_iterable_dataset_closes_the_pack_when_its_vit_slots_are_full(data, cap):
    """ViT images of 16 patch rows into `cap` slots: where a pack's images would hold more rows than
    the slots, the JAX packer fails in to_batch and the port closes the pack before the sample that
    would overflow them; every pack the JAX packer does emit is the port's too."""
    _, cfg = data

    def packer_cfg(pack):
        return pack.PackerConfig(expected_num_tokens=150, max_num_tokens=256, max_num_tokens_per_sample=200,
                                 image_num_range=(2, 3), max_vit_patches=cap, sorted_layout=True,
                                 geo_start_bucket=16, max_ce_slots=128)

    random.seed(11)
    jax_packs = iter(jpack.PackedIterableDataset(_groups(jreg, cfg), TOKEN_IDS, packer_cfg(jpack)))
    want = []
    try:
        want += [next(jax_packs) for _ in range(12)]
    except AssertionError as e:  # the JAX pack_views asserts n <= pad_to
        assert e.args[0][1] == cap and e.args[0][0] > cap
    packed = tpack.PackedIterableDataset(_groups(treg, cfg), TOKEN_IDS, packer_cfg(tpack),
                                         group_rng=random.Random(11))
    it = iter(packed)
    got = [next(it) for _ in range(12)]
    assert_same(got[:len(want)], want)
    rows = [int((b["vit_seg"] >= 0).sum()) for b in got]
    assert all(len(b["vit_patches"]) == cap for b in got) and max(rows) == cap, rows
    assert len(want) == (12 if cap == 64 else 0), len(want)  # 64 fits every pack the JAX packer draws here
    assert packed.too_long_in_a_row == 0


def test_fold_data_status_matches():
    dixs = [{"dataset_name": "a", "worker_id": 0, "data_indexes": 3}, {"dataset_name": "b", "worker_id": 1,
                                                                       "data_indexes": 0},
            {"dataset_name": "a", "worker_id": 0, "data_indexes": 5}]
    got, want = tpack.fold_data_status({"c": {0: 1}}, dixs), jpack.fold_data_status({"c": {0: 1}}, dixs)
    assert got == want == {"c": {0: 1}, "a": {0: 5}, "b": {1: 0}}


def test_registry_builds_the_same_groups_from_yaml(data, tmp_path, monkeypatch):
    root, cfg = data
    path = tmp_path / "joint.yaml"
    path.write_text(yaml.safe_dump(cfg))
    loaded = treg.load_yaml_config(str(path))
    assert loaded == jreg.load_yaml_config(str(path)) == cfg
    status = {"tiny_scenes": {"0": 1}, "tiny_chats": {"0": 2}}
    got, want = treg.build_groups_from_config(loaded, data_status=status), jreg.build_groups_from_config(
        loaded, data_status=status)
    assert [(g["name"], g["weight"], g["is_mandatory"]) for g in got] == [
        (g["name"], g["weight"], g["is_mandatory"]) for g in want]
    keys = ("dataset_name", "jsonl_paths", "img_size", "target_hw", "image_root", "num_video_frames", "data_status",
            "data_paths", "prompt_ids")
    for g, w in zip(got, want):
        assert type(g["dataset"]).__name__ == type(w["dataset"]).__name__
        assert {k: getattr(g["dataset"], k, None) for k in keys} == {k: getattr(w["dataset"], k, None) for k in keys}
    treg.register_dataset("recon", "registered", jsonl_path=cfg["recon"]["dataset_info"]["tiny_scenes"]["jsonl_path"])
    assert treg.build_groups_from_config({"recon": {"dataset_names": ["registered"]}})[0]["dataset"].img_size == 518
    # a recon_then_und group over a parquet directory, with its DINOv2 target size
    from g2vlm_tpu_torch.data.synthetic import spar_row, write_spar_parquet

    (tmp_path / "spar").mkdir()
    write_spar_parquet(str(tmp_path / "spar" / "rows.parquet"), [spar_row(np.random.default_rng(0), "scannet",
                                                                          "nav")])
    rtu = {"recon_then_und": {"dataset_names": ["spatial"], "dino_image_transform_args": {"target_size": 56},
                              "is_mandatory": True, "dataset_info": {"spatial": {"data_dir": str(tmp_path / "spar"),
                                                                                 "num_used_data": 2}}}}
    got, want = treg.build_groups_from_config(rtu), jreg.build_groups_from_config(rtu)
    assert [(g["name"], g["weight"], g["is_mandatory"]) for g in got] == [
        (g["name"], g["weight"], g["is_mandatory"]) for g in want] == [("recon_then_und", 1.0, True)]
    keys = ("dataset_name", "img_size", "vit_target_hw", "data_paths", "data_paths_per_rank")
    assert {k: getattr(got[0]["dataset"], k) for k in keys} == {k: getattr(want[0]["dataset"], k) for k in keys}
    assert got[0]["dataset"].img_size == 56 and len(got[0]["dataset"].data_paths) == 2
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        treg.load_yaml_config(str(path))
