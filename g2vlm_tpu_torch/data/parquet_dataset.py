"""Parquet streaming base + path utilities (local and remote filesystems).

The port's own copy of g2vlm_tpu/data/parquet_dataset.py, which it does not
import; tests/test_torch_recon_then_und.py holds the two equal. Two
differences: the cross-rank path merge gathers through torch.distributed
(`all_gather_object` when a process group is up, the identity otherwise),
where the JAX package uses its multihost allgather; and where the JAX
iterable skips every row whose parse raises, forever, the port raises once
`MAX_FAILED_ROWS_IN_A_ROW` rows in a row have, with the last row's error.

Behavioral spec: reference data/interleave_datasets/interleave_dataset.py:7-224
(ParquetStandardIterableDataset: row-group-sharded iteration with
[parquet_idx, row_group_id, row_idx] resume) and data/parquet_utils.py:15-84
(get_parquet_data_paths with rank-sharded listing + all_gather_object merge;
init_arrow_pf_fs HDFS/local factory). Any `scheme://` URI resolves through
pyarrow.fs.FileSystem.from_uri (hdfs, s3, gs, file, ...), and
`register_fs_factory` installs custom schemes (the petrel-style cluster
hook)."""

from __future__ import annotations

import glob
import os
import re
from typing import Callable, Iterator, List, Optional

from .distributed import DistributedIterable

# scheme -> callable(uri) -> (pyarrow.fs.FileSystem, fs-native path).
# Deployment hook for cluster-specific stores (reference init_arrow_pf_fs's
# "customize this for your cluster" HDFS knobs, parquet_utils.py:60-84).
_FS_FACTORIES: dict = {}

_URI_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")

# rows in a row whose parse_row raised, after which ParquetIterable raises
MAX_FAILED_ROWS_IN_A_ROW = 100


def register_fs_factory(scheme: str, factory: Callable) -> None:
    """Install a filesystem factory for a URI scheme. factory(uri) must
    return (pyarrow.fs.FileSystem, path-within-fs)."""
    _FS_FACTORIES[scheme] = factory


def resolve_fs(path: str):
    """path or URI -> (pyarrow FileSystem | None, fs-native path). None means
    a plain local path (callers keep os/glob semantics)."""
    m = _URI_RE.match(path)
    if not m:
        return None, path
    scheme = m.group(1)
    if scheme in _FS_FACTORIES:
        return _FS_FACTORIES[scheme](path)
    import pyarrow.fs as pafs

    return pafs.FileSystem.from_uri(path)


def open_parquet(path: str):
    """pq.ParquetFile through whatever filesystem the path resolves to."""
    import pyarrow.parquet as pq

    fs, p = resolve_fs(path)
    if fs is None:
        return pq.ParquetFile(p)
    return pq.ParquetFile(fs.open_input_file(p))


def _list_parquet_dir(d: str) -> List[str]:
    fs, p = resolve_fs(d)
    if fs is None:
        return sorted(glob.glob(os.path.join(p, "**", "*.parquet"), recursive=True))
    import pyarrow.fs as pafs

    scheme = _URI_RE.match(d).group(1)
    infos = fs.get_file_info(pafs.FileSelector(p, recursive=True))
    return sorted(
        f"{scheme}://{i.path}"
        for i in infos
        if i.type == pafs.FileType.File and i.path.endswith(".parquet")
    )


def merge_paths_across_hosts(local_paths: List[str]) -> List[str]:
    """Union of every rank's path list, in rank order and so the same on
    every rank: the reference's dist.all_gather_object merge
    (parquet_utils.py:46-56). Without a process group of more than one
    rank: the identity."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return list(local_paths)
    gathered: List[Optional[List[str]]] = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, list(local_paths))
    return [p for paths in gathered for p in paths]


def get_parquet_data_paths(
    dirs: List[str],
    repeats: Optional[List[int]] = None,
    rank: int = 0,
    world_size: int = 1,
) -> List[str]:
    """Expand parquet directories (local paths or fs URIs) to repeat-weighted
    file lists (reference parquet_utils.py:15-56). With world_size > 1 each
    rank lists a contiguous chunk of the dirs and the union is allgathered —
    listing a many-thousand-shard remote store is parallelized across ranks
    exactly like the reference's chunked listing + all_gather_object."""
    repeats = repeats or [1] * len(dirs)
    pairs = list(zip(dirs, repeats))
    sharded = world_size > 1
    if sharded:
        chunk = -(-len(pairs) // world_size)
        pairs = pairs[rank * chunk : rank * chunk + chunk]
    out: List[str] = []
    for d, rep in pairs:
        files = _list_parquet_dir(d)
        for _ in range(max(int(rep), 1)):
            out.extend(files)
    return merge_paths_across_hosts(out) if sharded else out


class ParquetIterable(DistributedIterable):
    """Iterates rows of sharded parquet files with row-group granularity and
    resume support. Subclasses implement parse_row(row_dict) -> sample|None."""

    def __init__(
        self,
        dataset_name: str,
        parquet_files: List[str],
        rows_per_shard_hint: int = 0,
        **dist_kwargs,
    ):
        super().__init__(dataset_name, **dist_kwargs)
        self.data_paths = [(f, i) for i, f in enumerate(parquet_files)]
        self.set_epoch()

    def parse_row(self, row: dict):
        raise NotImplementedError

    def __iter__(self) -> Iterator:
        files, worker_id = self.get_data_paths_per_worker()
        cursor = self.status_for_worker(worker_id)
        if cursor is not None:
            start_file, start_rg, start_row = cursor
            start_row += 1  # resume AFTER the last consumed row
        else:
            start_file = start_rg = start_row = 0
        failed = 0
        while True:
            for fi, (path, _) in enumerate(files):
                if fi < start_file:
                    continue
                pf = open_parquet(path)
                for rg in range(pf.num_row_groups):
                    if fi == start_file and rg < start_rg:
                        continue
                    table = pf.read_row_group(rg)
                    rows = table.to_pylist()
                    row0 = start_row if (fi == start_file and rg == start_rg) else 0
                    for ri, row in enumerate(rows):
                        if ri < row0:
                            continue
                        try:
                            sample = self.parse_row(row)
                        except Exception as e:  # a bad row is skipped; a run of them is a fault
                            failed += 1
                            if failed >= MAX_FAILED_ROWS_IN_A_ROW:
                                raise RuntimeError(
                                    f"{type(self).__name__} {self.dataset_name!r}: {failed} rows in a row failed "
                                    f"to parse, the last [{fi}, {rg}, {ri}] of {path}: {type(e).__name__}: {e}"
                                ) from e
                            continue
                        failed = 0
                        if sample is None:
                            continue
                        sample["data_indexes"] = {
                            "data_indexes": [fi, rg, ri],
                            "worker_id": worker_id,
                            "dataset_name": self.dataset_name,
                        }
                        yield sample
            start_file = start_rg = start_row = 0
