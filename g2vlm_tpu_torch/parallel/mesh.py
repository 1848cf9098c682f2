"""Device mesh and sharding rules (port of g2vlm_tpu/parallel/mesh.py) on
FSDP2 and DTensor.

The mesh has the JAX package's three axes, ("dp", "fsdp", "tp"):

  * dp    data-parallel replicas: FSDP2's replicate axis (HSDP);
  * fsdp  parameter sharding (`fully_shard`, ZeRO-3): each parameter split
          over the ranks of a dp group, all-gathered for its use;
  * tp    tensor parallelism in the MoT decoder (Megatron layout): q / k / v
          and the MLP's gate / up column-parallel, o and down row-parallel,
          the lm_head's vocabulary split.

`shard_model` places the tp-split parameters as DTensors on the tp sub-mesh,
then shards every parameter over the ("dp", "fsdp") sub-mesh with
`fully_shard`: once per decoder layer and once at the root. The port's code
calls the model through functions and methods rather than `forward`, so the
layers register `forward_train` and `forward_geo_main` as FSDP2 forward
methods and a whole-model call goes through `G2VLM.forward(fn, ...)`.

The tp-split projections are computed on their local shards
(`ops.linear.tp_linear`, which `ops.linear.linear` calls for a DTensor
weight): a column-parallel projection gives the rank's own heads or
features, a row-parallel one sums the ranks' partial products. The layers take their head counts from the
tensors, so a rank runs nh / tp query heads against kvh / tp KV heads (the
GQA group unchanged). A projection whose heads or features do not divide tp
stays whole, as `_divides` leaves an axis unsharded in the JAX package.

Where FSDP2 shards a parameter: dim 0, except a column-parallel weight
(tp on its output rows), which fsdp splits on its input columns: the JAX
layout (fsdp on `din`, tp on `dout`). The numbers do not depend on it.

`shard_map_compat` has no counterpart: it papers over an API move between
JAX versions, and the port's collectives are plain `torch.distributed`
calls (`parallel/comm.py`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch.distributed as dist
from torch import nn

DP, FSDP, TP = "dp", "fsdp", "tp"

_TP_COL = frozenset(("q_proj", "k_proj", "v_proj", "q_proj_moe_geo", "k_proj_moe_geo", "v_proj_moe_geo",
                     "gate_proj", "up_proj"))  # output features over tp
_TP_ROW = frozenset(("o_proj", "o_proj_moe_geo", "down_proj"))  # input features over tp
_ATTN = frozenset(("q_proj", "k_proj", "v_proj", "o_proj"))


def make_mesh(n_devices: Optional[int] = None, dp: int = 1, fsdp: Optional[int] = None, tp: int = 1,
              device_type: str = "cuda"):
    """The ("dp", "fsdp", "tp") DeviceMesh over the process group's ranks
    (which must already be initialised); fsdp defaults to what dp and tp
    leave of the world."""
    from torch.distributed.device_mesh import init_device_mesh

    if n_devices is None:
        n_devices = dist.get_world_size()
    if fsdp is None:
        fsdp = n_devices // (dp * tp)
    assert dp * fsdp * tp == n_devices, (dp, fsdp, tp, n_devices)
    return init_device_mesh(device_type, (dp, fsdp, tp), mesh_dim_names=(DP, FSDP, TP))


def _divides(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0 and dim >= 2 * n


def tensor_parallel_placements(model: nn.Module, n_tp: int) -> Dict[str, int]:
    """{parameter name: the tensor dim split over tp} by the TP plan: 0 for a
    column-parallel weight or bias and the lm_head's vocabulary, 1 for a
    row-parallel weight. The attention is split only when its query and KV
    head counts both divide tp (a rank keeps whole GQA groups), the MLP when
    its intermediate size does, the lm_head when the vocabulary does."""
    if n_tp == 1:
        return {}
    cfg = model.cfg.llm
    attn = (cfg.num_attention_heads % n_tp == 0 and cfg.num_key_value_heads % n_tp == 0)
    mlp = _divides(cfg.intermediate_size, n_tp)
    out = {}
    for name, _ in model.named_parameters():
        if not name.startswith("language_model.model.layers."):
            continue
        *_, mod, leaf = name.split(".")
        base = mod.replace("_moe_geo", "")
        if not (attn if base in _ATTN else mlp):
            continue
        if mod in _TP_COL:
            out[name] = 0
        elif mod in _TP_ROW and leaf == "weight":
            out[name] = 1
    if _divides(cfg.vocab_size, n_tp):
        out["language_model.lm_head.weight"] = 0
    return out


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """The counterpart of `shard_params`: the TP plan on the tp sub-mesh,
    then `fully_shard` per decoder layer and at the root over ("dp", "fsdp")
    (HSDP when dp > 1). In place; returns the model. Its parameters must be
    the same on every rank (the same seed or checkpoint), on the mesh's
    device. Call it before the optimizer is built."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    model.language_model.check_serving(sharded=True)
    tp_mesh = mesh[TP]
    for name, dim in tensor_parallel_placements(model, tp_mesh.size()).items():
        mod_name, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        p = getattr(mod, leaf)
        setattr(mod, leaf, nn.Parameter(distribute_tensor(p.detach(), tp_mesh, [Shard(dim)]),
                                        requires_grad=p.requires_grad))

    def fsdp_dim(p):
        if isinstance(p, DTensor) and p.ndim == 2 and p.placements[0] == Shard(0):
            return Shard(1)  # column-parallel weight: fsdp on the input columns
        return Shard(0)

    data_mesh = mesh[DP, FSDP]
    for layer in model.language_model.model.layers:
        fully_shard(layer, mesh=data_mesh, shard_placement_fn=fsdp_dim)
        register_fsdp_forward_method(layer, "forward_train")
        register_fsdp_forward_method(layer, "forward_geo_main")
    fully_shard(model, mesh=data_mesh, shard_placement_fn=fsdp_dim)
    model._g2_mesh = mesh
    return model


def model_mesh(model: nn.Module):
    """The mesh `shard_model` put the model on, or None."""
    return getattr(model, "_g2_mesh", None)


def addressable_param_bytes(model: nn.Module) -> int:
    """Bytes of the parameters this rank holds: each sharded parameter's
    local shard, each other parameter whole."""
    from torch.distributed.tensor import DTensor

    total = 0
    for p in model.parameters():
        t = p.to_local() if isinstance(p, DTensor) else p
        total += t.numel() * t.element_size()
    return total
