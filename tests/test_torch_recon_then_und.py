"""The port's recon_then_und group against the JAX package's on the CPU: the
markers of every task type, `parse_row` on SPAR-style rows in each depth and
pose convention, the parquet listing through plain paths, `file://` URIs and a
registered filesystem factory, the row stream and its cursor resume, and the
three groups of configs/joint_train.yaml through both registries and both
packers into `train_forward`; and the port's differences: a run of rows that
fail to parse raises, the path merge runs on torch.distributed (two gloo
processes), and the group's views take the pack's drawn shape, where the JAX
packer raises on joint_train.yaml's two mandatory groups."""

import copy
import dataclasses
import json
import os
import random
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
import yaml
from PIL import Image

from g2vlm_tpu.config import tiny_test_config as jax_tiny_config
from g2vlm_tpu.data import draw_marker as jdm
from g2vlm_tpu.data import packing as jpack
from g2vlm_tpu.data import parquet_dataset as jpq
from g2vlm_tpu.data import recon_then_und_dataset as jrtu
from g2vlm_tpu.data import registry as jreg
from g2vlm_tpu.models import g2vlm as jg
from g2vlm_tpu.train import trainer as jtr
from g2vlm_tpu_torch.config import tiny_test_config
from g2vlm_tpu_torch.data import draw_marker as tdm
from g2vlm_tpu_torch.data import packing as tpack
from g2vlm_tpu_torch.data import parquet_dataset as tpq
from g2vlm_tpu_torch.data import recon_then_und_dataset as trtu
from g2vlm_tpu_torch.data import registry as treg
from g2vlm_tpu_torch.data.synthetic import SPAR_SCENES, make_joint_train_data, spar_row, write_spar_parquet
from g2vlm_tpu_torch.train import trainer as ttr
from g2vlm_tpu_torch.weights import build_model, state_dict_from_jax
from test_torch_data_path import assert_same
from torch_alternates import two_threads  # noqa: F401

TOKEN_IDS = dict(bos_token_id=5100, eos_token_id=5101, start_of_image=5102, end_of_image=5103)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = sorted(jdm.TASK_MARKERS)


def _datasets(files, **kw):
    kw = dict(dict(img_size=56, vit_target_hw=(56, 56)), **kw)
    return trtu.ReconThenUndDataset("spar", files, **kw), jrtu.ReconThenUndDataset("spar", files, **kw)


def test_marker_registry_matches():
    assert tdm.TASK_MARKERS == jdm.TASK_MARKERS and tdm.COLOR_RGB == jdm.COLOR_RGB
    assert set(tdm.DRAW_FUNCTIONS) == set(jdm.DRAW_FUNCTIONS) == set(TASKS)
    for mod in (tdm, jdm):
        with pytest.raises(KeyError, match="unknown spatial-QA task type"):
            mod.apply_markers([Image.new("RGB", (8, 8))], {}, "no_such_task")


@pytest.mark.parametrize("task", TASKS)
def test_markers_match_jax_for_every_task_type(task):
    """Each task type's markers drawn on two views by both packages: the same pixels; a task with
    markers changes some."""
    rng = np.random.default_rng(TASKS.index(task))
    arrays = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8) for _ in range(2)]
    entry = spar_row(rng, "scannet", task, n_views=1)["metadata"]
    drawn = []
    for mod in (tdm, jdm):
        imgs = [Image.fromarray(a.copy()) for a in arrays]
        mod.DRAW_FUNCTIONS[task](imgs, copy.deepcopy(entry))
        drawn.append([np.asarray(im) for im in imgs])
    for got, want in zip(*drawn):
        np.testing.assert_array_equal(got, want)
    changed = any((d != a).any() for d, a in zip(drawn[0], arrays))
    assert changed == bool(jdm.TASK_MARKERS[task]), task


@pytest.mark.parametrize("scene", list(SPAR_SCENES) + ["matterport3d", "3rscan"])
def test_parse_row_matches_jax(scene):
    """A row in each scene's depth and pose convention (depth maps at half the images' size, so the
    scannet image follows the depth and the others' depth follows the image), with markers; the
    sample bitwise equal, the ViT images at 56x56 and at the group's 768x768."""
    rng = np.random.default_rng(3)
    row = spar_row(rng, scene, "depth_prediction_oc_mv", n_views=3)
    for raw in row["depth_list"]:
        np.testing.assert_array_equal(trtu.decode_depth(raw, scene), jrtu.decode_depth(raw, scene))
    for pose in row["poses"]:
        np.testing.assert_array_equal(trtu.decode_pose(pose, scene), jrtu.decode_pose(pose, scene))
    for vit_hw in ((56, 56), (768, 768)):
        t, j = _datasets([], vit_target_hw=vit_hw)
        for ds in (t, j):
            ds.set_step_rng(5)
        got, want = t.parse_row(copy.deepcopy(row)), j.parse_row(copy.deepcopy(row))
        assert_same(got, want, f"{scene} {vit_hw}")
        assert len(got["dino_views"]) == 3 and got["plan"][-1]["loss"] == 1
        assert all(v["point_masks"].any() for v in got["dino_views"])


@pytest.fixture
def parquet_tree(tmp_path):
    """Two parquet files of four rows each (row groups of two) and a text file, under a subdirectory."""
    root = tmp_path / "store"
    (root / "sub").mkdir(parents=True)
    for i, rel in enumerate(["a.parquet", "sub/b.parquet"]):
        pq.write_table(pa.Table.from_pylist([{"val": i * 10 + j} for j in range(4)]), str(root / rel),
                       row_group_size=2)
    (root / "notes.txt").write_text("ignored")
    return root


@pytest.mark.parametrize("form", ["plain", "file_uri", "factory"])
def test_parquet_listing_matches_jax(parquet_tree, form):
    import pyarrow.fs as pafs

    def factory(uri):
        return pafs.SubTreeFileSystem(str(parquet_tree), pafs.LocalFileSystem()), uri[len("mockfs://"):]

    dirs = {"plain": str(parquet_tree), "file_uri": f"file://{parquet_tree}", "factory": "mockfs://"}[form]
    listed = []
    for mod in (tpq, jpq):
        mod.register_fs_factory("mockfs", factory)
        paths = mod.get_parquet_data_paths([dirs], repeats=[2])
        listed.append(paths)
        assert [mod.open_parquet(p).metadata.num_rows for p in paths] == [4] * 4
    assert listed[0] == listed[1] and len(listed[0]) == 4
    assert tpq.resolve_fs(str(parquet_tree)) == jpq.resolve_fs(str(parquet_tree)) == (None, str(parquet_tree))
    other = parquet_tree.parent / "other"
    other.mkdir()
    pq.write_table(pa.Table.from_pylist([{"val": 99}]), str(other / "c.parquet"))
    two = [str(parquet_tree), str(other)]
    for rank in (0, 1):  # one process: each rank lists its own chunk of the dirs
        assert (tpq.get_parquet_data_paths(two, rank=rank, world_size=2)
                == jpq.get_parquet_data_paths(two, rank=rank, world_size=2))


@pytest.fixture(scope="module")
def spar_file(tmp_path_factory):
    """Five SPAR rows in three row groups; the third row's first pose is not finite, so its parse
    raises and the row is skipped."""
    rng = np.random.default_rng(1)
    rows = [spar_row(rng, SPAR_SCENES[i % 2], TASKS[(7 * i) % len(TASKS)]) for i in range(5)]
    rows[2]["poses"][0] = [float("nan")] * 16
    return write_spar_parquet(str(tmp_path_factory.mktemp("spar") / "rows.parquet"), rows)


def _stream(ds, n, seed0=20):
    """n samples, the crop generator re-seeded before each pull as the packer does."""
    it = iter(ds)
    out = []
    for i in range(n):
        ds.set_step_rng(seed0 + i)
        out.append(next(it))
    return out


def test_row_stream_and_cursor_resume_match_jax(spar_file):
    """The stream over the file (past its end: it starts over) equal in both packages, the cursors
    [file, row group, row]; from each cursor, JSON round-tripped, both resume at the next row."""
    t, j = _datasets([spar_file])
    got, want = _stream(t, 6), _stream(j, 6)
    assert_same(got, want)
    cursors = [s["data_indexes"]["data_indexes"] for s in got]
    assert cursors == [[0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 2, 0], [0, 0, 0], [0, 0, 1]]
    for k in range(4):
        status = json.loads(json.dumps({"0": cursors[k]}))
        t, j = _datasets([spar_file], data_status=status)
        resumed = _stream(t, 2, seed0=20 + k + 1)
        assert_same(resumed, _stream(j, 2, seed0=20 + k + 1))
        assert_same(resumed, got[k + 1:k + 3])


class _Failing(tpq.ParquetIterable):
    """Rows whose parse raises unless their value is in `good`."""

    def __init__(self, *a, good=(), **kw):
        super().__init__(*a, **kw)
        self.good = set(good)

    def parse_row(self, row):
        if row["val"] not in self.good:
            raise KeyError(f"no field for {row['val']}")
        return dict(row)


def test_a_run_of_rows_that_fail_to_parse_raises(parquet_tree):
    """A bad row is skipped, as in the JAX package; MAX_FAILED_ROWS_IN_A_ROW of them in a row raise
    with the last one's error, where the JAX iterable would loop forever."""
    files = tpq.get_parquet_data_paths([str(parquet_tree)])
    it = iter(_Failing("mixed", files, good={0, 2, 3, 10, 13}))
    vals = [next(it)["val"] for _ in range(6)]
    assert sorted(vals[:5]) == [0, 2, 3, 10, 13] and vals[5] == vals[0]
    ds = _Failing("bad", files)
    with pytest.raises(RuntimeError, match=f"{tpq.MAX_FAILED_ROWS_IN_A_ROW} rows in a row failed") as e:
        next(iter(ds))
    assert isinstance(e.value.__cause__, KeyError)


def test_merge_paths_without_a_process_group_is_the_identity():
    assert not torch.distributed.is_initialized()
    paths = ["b.parquet", "a.parquet"]
    assert tpq.merge_paths_across_hosts(paths) == jpq.merge_paths_across_hosts(paths) == paths


def _merge_worker(rank, port, dirs, queue):
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2)
    try:
        queue.put((rank, tpq.get_parquet_data_paths(dirs, rank=rank, world_size=2)))
    finally:
        torch.distributed.destroy_process_group()


def test_merge_paths_across_two_gloo_processes(parquet_tree):
    """Two ranks list one chunk of the dirs each; all_gather_object gives both the union in rank
    order, what one process lists whole."""
    import multiprocessing as mp

    other = parquet_tree.parent / "other"
    other.mkdir()
    pq.write_table(pa.Table.from_pylist([{"val": 99}]), str(other / "c.parquet"))
    dirs = [str(parquet_tree), str(other)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_merge_worker, args=(r, port, dirs, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    assert all(p.exitcode == 0 for p in procs)
    assert got[0] == got[1] == tpq.get_parquet_data_paths(dirs) and len(got[0]) == 3


@pytest.fixture(scope="module")
def three_groups(tmp_path_factory):
    """configs/joint_train.yaml's three groups over data at a 56-wide target, written as YAML and
    read back by both packages."""
    root = tmp_path_factory.mktemp("three")
    cfg = make_joint_train_data(str(root), target_size=56, vit_hw=(56, 56), n_spar_rows=4, video_hw=(48, 64),
                                frames_per_video=2)
    path = root / "joint.yaml"
    path.write_text(yaml.safe_dump(cfg))
    loaded = treg.load_yaml_config(str(path))
    assert loaded == jreg.load_yaml_config(str(path)) == cfg
    return loaded


def _groups(reg, cfg, status=None):
    """The groups of `cfg`; the recon_then_und datasets' ViT images at 56x56 (the group's 768x768 would
    make each image 729 tokens, too many for a tiny pack)."""
    groups = reg.build_groups_from_config(cfg, data_status=status)
    for g in groups:
        if g["name"] == "recon_then_und":
            g["dataset"].vit_target_hw = (56, 56)
    return groups


def _packer_cfg(pack, aspect=(1.0, 1.0)):
    return pack.PackerConfig(expected_num_tokens=300, max_num_tokens=512, max_num_tokens_per_sample=256,
                             image_num_range=(2, 3), aspect_ratio_range=aspect, max_vit_patches=512,
                             sorted_layout=True, geo_start_bucket=16, max_ce_slots=128)


def test_joint_train_yaml_builds_the_three_groups_in_both_packages(three_groups):
    with open(os.path.join(ROOT, "configs", "joint_train.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert list(cfg) == list(three_groups) == ["recon", "recon_then_und", "vlm_sft"]
    written = {name: next(iter(g["dataset_info"].values())) for name, g in three_groups.items()}
    for name, g in cfg.items():  # the repo's file, with the written data's locations filled in
        g["dataset_info"] = {n: written[name] for n in g["dataset_names"]}
    got, want = treg.build_groups_from_config(cfg), jreg.build_groups_from_config(cfg)
    assert [(g["name"], type(g["dataset"]).__name__, g["weight"], g["is_mandatory"]) for g in got] == [
        (g["name"], type(g["dataset"]).__name__, g["weight"], g["is_mandatory"]) for g in want] == [
        ("recon", "JsonlReconDataset", 1.0, True), ("recon_then_und", "ReconThenUndDataset", 1.0, True),
        ("vlm_sft", "JsonlVlmDataset", 1.0, False)]
    keys = ("dataset_name", "img_size", "vit_target_hw", "target_hw", "num_video_frames", "data_paths")
    for g, w in zip(got, want):
        assert {k: getattr(g["dataset"], k, None) for k in keys} == {k: getattr(w["dataset"], k, None) for k in keys}
    assert got[1]["dataset"].img_size == 518 and got[1]["dataset"].vit_target_hw == (768, 768)
    assert got[2]["dataset"].num_video_frames == 12


def _fields(b):
    fields = {k: b[k] for k in ("text_ids", "text_indexes", "dino_indexes", "vit_indexes", "is_geo", "position_ids",
                                "doc_id", "fn_id", "noise_id", "pos", "ce_indexes", "ce_labels", "ce_weights",
                                "dino_images", "vit_patches", "vit_coords", "vit_seg")}
    fields.update(world_points=b["world_points"][None], point_masks=b["point_masks"][None],
                  extrinsics=b["extrinsics"][None], normal_batch_mask=np.ones((1,), bool))
    return fields


def test_three_groups_pack_and_train_forward_match_jax(three_groups):
    """The slice as a whole: both registries and both packers over the three groups give the same
    first two packs, array for array (square draws: the JAX packer cannot stack anything else with
    the recon group, see the next test); `train_forward` of tiny_test_config on the first pack gives
    the same loss and loss terms within 1e-3."""
    random.seed(11)  # the JAX package draws each sample's group from the global generator
    jit_ = iter(jpack.PackedIterableDataset(_groups(jreg, three_groups), TOKEN_IDS, _packer_cfg(jpack)))
    want = [next(jit_) for _ in range(2)]
    tit = iter(tpack.PackedIterableDataset(_groups(treg, three_groups), TOKEN_IDS, _packer_cfg(tpack),
                                           group_rng=random.Random(11)))
    got = [next(tit) for _ in range(2)]
    assert_same(got, want)
    names = {d["dataset_name"] for b in got for d in b["data_indexes"]}
    assert names == {"tiny_scenes", "tiny_spar", "tiny_chats"}
    assert any(len(b["vit_grids"]) for b in got)

    jcfg, cfg = (dataclasses.replace(c, llm=dataclasses.replace(c.llm, vocab_size=5120))
                 for c in (jax_tiny_config(), tiny_test_config()))
    rng = np.random.default_rng(0)
    params = jg.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)
    for head in ("point_head", "global_point_head"):
        params[head]["proj"]["w"] = params[head]["proj"]["w"] * np.float32(0.1)
    fields, geo_start = _fields(got[0]), got[0]["geo_start"]
    want_loss, want_terms = jtr.train_forward(
        jax.tree.map(jnp.asarray, params), jtr.TrainBatch(**{k: jnp.asarray(v) for k, v in fields.items()}), jcfg,
        compute_dtype=jnp.float32, remat=False, geo_start=geo_start)
    model = build_model(cfg, device="cpu", seed=None).train()
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    with torch.no_grad():
        got_loss, got_terms = ttr.train_forward(model, ttr.TrainBatch.from_numpy(**fields), cfg,
                                                compute_dtype=torch.float32, remat=False, geo_start=geo_start)
    assert float(want_terms["ce"]) > 0
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-3)
    assert set(got_terms) == set(want_terms)
    for k in want_terms:
        np.testing.assert_allclose(got_terms[k].item(), float(want_terms[k]), rtol=1e-3, atol=1e-6, err_msg=k)


def test_three_groups_resume_exactly_and_views_take_the_packs_shape(three_groups):
    """With the default aspect-ratio draws the JAX packer raises on its first pack (the recon
    group's views follow the draw, the recon_then_und group's stay square); the port's packs hold
    one view shape, and a stream resumed from its JSON status after pack 2, parquet cursor
    included, gives the uninterrupted stream's packs 3 and 4."""
    random.seed(11)
    with pytest.raises(ValueError, match="same shape"):
        next(iter(jpack.PackedIterableDataset(_groups(jreg, three_groups), TOKEN_IDS,
                                              _packer_cfg(jpack, aspect=(0.5, 1.2)))))
    packed = tpack.PackedIterableDataset(_groups(treg, three_groups), TOKEN_IDS, _packer_cfg(tpack, (0.5, 1.2)),
                                         group_rng=random.Random(11))
    it = iter(packed)
    got = [next(it) for _ in range(2)]
    status = json.loads(json.dumps(packed.resume_status()))
    got += [next(it) for _ in range(2)]
    assert any(b["dino_images"].shape[2] != 56 for b in got)  # a non-square draw
    assert all(len(b["dino_images"]) == len(b["world_points"]) for b in got)
    assert len(status["tiny_spar"]["0"]) == 3  # [file, row group, row]
    resumed = tpack.PackedIterableDataset(_groups(treg, three_groups, status), TOKEN_IDS,
                                          _packer_cfg(tpack, (0.5, 1.2)), group_rng=random.Random(0), resume=status)
    rit = iter(resumed)
    assert_same([next(rit) for _ in range(2)], got[2:])
