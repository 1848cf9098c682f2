"""Dataset registry + YAML group-config loading.

The port's own copy of g2vlm_tpu/data/registry.py, which it does not import;
tests/test_torch_data_path.py holds the groups it builds equal to the JAX
package's.

Behavioral spec: reference data/dataset_info.py:1-37 (name -> class + disk
locations) and data/configs/{pretrain,joint_train}.yaml consumed by
PackedDataset.build_datasets (dataset_base.py:126-195): per-group transform
args, sampling weights, mandatory flags."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .recon_dataset import JsonlReconDataset
from .recon_then_und_dataset import ReconThenUndDataset
from .vlm_dataset import JsonlVlmDataset

DATASET_REGISTRY = {
    "vlm_sft": JsonlVlmDataset,
    "recon_then_und": ReconThenUndDataset,
    "recon": JsonlReconDataset,
}

# name -> disk locations; fill in deployment paths (reference DATASET_INFO).
DATASET_INFO: Dict[str, Dict[str, Dict[str, Any]]] = {
    "vlm_sft": {},
    "recon_then_und": {},
    "recon": {},
}


def register_dataset(group: str, name: str, **info) -> None:
    DATASET_INFO.setdefault(group, {})[name] = info


def build_groups_from_config(
    cfg: Dict[str, Any],
    tokenizer=None,
    local_rank: int = 0,
    world_size: int = 1,
    num_workers: int = 1,
    worker_id: int = 0,
    data_status: Optional[Dict[str, Any]] = None,
) -> List[Dict[str, Any]]:
    """YAML dict -> packer groups [{name, dataset, weight, is_mandatory}].

    cfg layout mirrors the reference YAML: top-level keys are group types
    ('recon', 'vlm_sft', 'recon_then_und'), each with dataset_names, weight,
    is_mandatory, and transform args."""
    groups = []
    for gname, gcfg in cfg.items():
        cls = DATASET_REGISTRY[gname]
        names = gcfg.get("dataset_names", [])
        # per-dataset disk locations may live inline in the YAML under
        # `dataset_info:` (deployment-configurable, unlike the reference's
        # hardcoded data/dataset_info.py) or in code via register_dataset
        inline_info = gcfg.get("dataset_info", {})
        for ds_name in names:
            info = dict(DATASET_INFO.get(gname, {}).get(ds_name, {}))
            info.update(inline_info.get(ds_name, {}))
            kwargs = dict(
                dataset_name=ds_name,
                tokenizer=tokenizer,
                local_rank=local_rank,
                world_size=world_size,
                num_workers=num_workers,
                worker_id=worker_id,
                data_status=(data_status or {}).get(ds_name),
            )
            if gname in ("recon",):
                kwargs["jsonl_paths"] = [info["jsonl_path"]]
                dargs = gcfg.get("dino_image_transform_args", {})
                if "target_size" in dargs:
                    kwargs["img_size"] = dargs["target_size"]
                if "prompt_ids" in gcfg:  # fixed prompt (tiny-vocab runs)
                    kwargs["prompt_ids"] = list(gcfg["prompt_ids"])
            elif gname == "vlm_sft":
                kwargs["jsonl_paths"] = [info["jsonl_path"]]
                kwargs["image_root"] = info.get("data_dir", "")
                fr = gcfg.get("frame_sampler_args", {})
                if "max_num_frames" in fr:
                    kwargs["num_video_frames"] = fr["max_num_frames"]
                vargs = gcfg.get("vit_image_transform_args", {})
                if "image_size_h" in vargs:
                    kwargs["target_hw"] = (
                        vargs["image_size_h"],
                        vargs.get("image_size_w", vargs["image_size_h"]),
                    )
            elif gname == "recon_then_und":
                # data_dir may be a local path or any fs URI (hdfs://,
                # s3://, or a register_fs_factory scheme); num_used_data
                # mirrors the reference's repeat-to-count weighting
                from .parquet_dataset import get_parquet_data_paths

                pq_dir = info.get("data_dir", "")
                kwargs["parquet_files"] = get_parquet_data_paths(
                    [pq_dir], repeats=[int(info.get("num_used_data", 1))]
                )
                dargs = gcfg.get("dino_image_transform_args", {})
                if "target_size" in dargs:
                    kwargs["img_size"] = dargs["target_size"]
            groups.append(
                dict(
                    name=gname,
                    dataset=cls(**kwargs),
                    weight=float(gcfg.get("weight", 1.0)),
                    is_mandatory=bool(gcfg.get("is_mandatory", False)),
                )
            )
    return groups


def load_yaml_config(path: str) -> Dict[str, Any]:
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"load_yaml_config needs PyYAML (the yaml module) to read {path}") from e

    with open(path) as f:
        return yaml.safe_load(f)
