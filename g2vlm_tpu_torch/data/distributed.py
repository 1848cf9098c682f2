"""Rank/worker file sharding for iterable datasets.

The port's own copy of g2vlm_tpu/data/distributed.py, which it does not import;
tests/test_torch_data_path.py holds the two equal.

Behavioral spec: reference data/distributed_iterable_dataset.py:8-61 — sorted
file list, epoch-seeded shuffle, contiguous per-rank slices, per-worker
subdivision (reversed), plus data_status-based fast-forward on resume
(reference dataset fast-forward, e.g. recon_dataset.py:614-624)."""

from __future__ import annotations

import random
from typing import Any, List, Optional, Sequence, Tuple


class DistributedIterable:
    """Base for sharded iterable datasets (no torch DataLoader dependency;
    worker identity is passed explicitly by the loader)."""

    def __init__(
        self,
        dataset_name: str,
        local_rank: int = 0,
        world_size: int = 1,
        num_workers: int = 1,
        worker_id: int = 0,
        data_status: Optional[List] = None,
    ):
        self.dataset_name = dataset_name
        self.local_rank = local_rank
        self.world_size = world_size
        self.num_workers = max(num_workers, 1)
        self.worker_id = worker_id
        self.data_status = data_status
        self.rng = random.Random()
        self.data_paths: Optional[List] = None
        self.epoch_seed: Optional[int] = None

    def set_epoch(self, seed: int = 42) -> None:
        self.epoch_seed = seed
        if self.data_paths is None:
            return
        if self.data_paths and isinstance(self.data_paths[0], tuple):
            paths = sorted(self.data_paths, key=lambda x: (x[0], x[1]))
        else:
            paths = sorted(self.data_paths)
        self.rng.seed(seed)
        self.rng.shuffle(paths)
        per_rank = len(paths) // self.world_size
        self.num_files_per_rank = per_rank
        lo = self.local_rank * per_rank
        self.data_paths_per_rank = paths[lo : lo + per_rank]

    def get_data_paths_per_worker(self) -> Tuple[List, int]:
        if self.data_paths is None:
            return [], self.worker_id
        if self.num_workers <= 1:
            return self.data_paths_per_rank, 0
        per_worker = self.num_files_per_rank // self.num_workers
        lo = per_worker * self.worker_id
        # reversed, matching the reference (distributed_iterable_dataset.py:56)
        return self.data_paths_per_rank[lo : lo + per_worker][::-1], self.worker_id

    def status_for_worker(self, worker_id: int):
        """This worker's resume cursor from data_status, or None. Accepts a
        list indexed by worker, or a dict keyed by int/str worker id (JSON
        roundtrips stringify keys)."""
        ds = self.data_status
        if ds is None:
            return None
        if isinstance(ds, dict):
            return ds.get(worker_id, ds.get(str(worker_id)))
        if worker_id < len(ds):
            return ds[worker_id]
        return None

    def __iter__(self):
        raise NotImplementedError
