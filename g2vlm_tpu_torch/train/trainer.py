"""Training step (port of g2vlm_tpu/train/trainer.py): the packed joint
forward (CE on answer spans + the Pi3 3D losses), the optimizer (global-norm
clip, then AdamW or Adam with factored second moments, decoupled weight decay,
a learning-rate schedule), the EMA of the parameters, and freezing.

One process, one device. The model holds fp32 master parameters; the forward
casts them to `compute_dtype` per use and recomputes layers in the backward
(`remat`). Frozen parameters have `requires_grad` off, so no gradient is ever
built for them. The optimizer is written out here rather than taken from
`torch.optim`, to follow optax's order of operations: decay on every trainable
leaf, the schedule read at the count before the step, a bf16 first moment that
is still updated in fp32.

With the conf head (`cfg.train_conf_pi3`) the sky masks of its loss come from
the batch's `sky_masks`, or else from the frozen SegFormer run on the batch's
views under `torch.no_grad`, as the JAX trainer predicts them in-program. The
SegFormer is always frozen.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import G2VLMConfig
from ..models import g2vlm as tg
from ..models import mot_decoder, qwen_vit, segformer
from ..ops.masks import TokenInfo
from . import loss as losses


@dataclasses.dataclass
class TrainBatch:
    """One packed training example, or with a leading axis on every field a
    stack of them (the data-parallel batch axis of the JAX trainer). All
    shapes are static; padding is masked through doc_id and the weights."""

    # packed sequence
    text_ids: torch.Tensor  # (T,)
    text_indexes: torch.Tensor  # (T,)
    dino_indexes: torch.Tensor  # (N*hw,) or (0,)
    vit_indexes: torch.Tensor  # (V,) or (0,)
    is_geo: torch.Tensor  # (S,) bool
    position_ids: torch.Tensor  # (3, S)
    doc_id: torch.Tensor  # (S,)
    fn_id: torch.Tensor
    noise_id: torch.Tensor
    pos: torch.Tensor
    # CE supervision (padded with weight 0)
    ce_indexes: torch.Tensor  # (C,)
    ce_labels: torch.Tensor  # (C,)
    ce_weights: torch.Tensor  # (C,)
    # recon supervision
    dino_images: torch.Tensor  # (N, 3, H, W) RESNET-normalized
    world_points: torch.Tensor  # (1, N, H, W, 3)
    point_masks: torch.Tensor  # (1, N, H, W) bool
    extrinsics: torch.Tensor  # (1, N, 4, 4)
    normal_batch_mask: torch.Tensor  # (1,) bool
    # ViT branch (joint recon + understanding batches): vit_indexes above is
    # padded with S (those slots are dropped); None = no ViT branch in this run
    vit_patches: Optional[torch.Tensor] = None  # (P, pdim)
    vit_coords: Optional[torch.Tensor] = None  # (P, 2)
    vit_seg: Optional[torch.Tensor] = None  # (P,) image index, -1 = padding
    # conf supervision: precomputed sky masks (1, N, H, W) bool
    sky_masks: Optional[torch.Tensor] = None

    def map(self, fn: Callable) -> "TrainBatch":
        """fn applied to every field that is not None."""
        return TrainBatch(**{
            f.name: None if getattr(self, f.name) is None else fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
        })

    @classmethod
    def from_numpy(cls, device=None, **arrays) -> "TrainBatch":
        return cls(**{k: None if a is None else torch.as_tensor(np.asarray(a), device=device)
                      for k, a in arrays.items()})


def train_forward(
    model: tg.G2VLM,
    batch: TrainBatch,
    cfg: G2VLMConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    ce_weight: float = 1.0,
    recon_weight: float = 1.0,
    remat: bool = True,
    geo_start: Optional[int] = None,
    conf_target_thresh: float = 0.02,
    head_view_chunk: int = 0,
    remat_group: int = 1,
    dino_remat_group: int = 1,
    remat_inner: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One packed sample -> scalar loss + details.

    geo_start: the static [und | geo] boundary of a sorted pack; it switches
    the MoT to the SPLIT expert mode (contiguous single-expert matmuls
    instead of MIXED's two experts on every row)."""
    lm = model.language_model
    s = batch.doc_id.shape[0]
    dev = batch.doc_id.device

    seq = torch.zeros((s, cfg.llm.hidden_size), dtype=compute_dtype, device=dev)
    text_emb = mot_decoder.embed_tokens(lm.model, batch.text_ids.long())
    seq = seq.index_put((batch.text_indexes.long(),), text_emb.to(compute_dtype))

    n, _, h, w = batch.dino_images.shape
    p = cfg.dino_patch_size
    hw = (h // p) * (w // p)
    dino_idx = batch.dino_indexes.long()
    dino_emb = tg.encode_dino_to_llm(
        model, batch.dino_images, compute_dtype, remat=remat, remat_group=dino_remat_group
    )
    seq = seq.index_put((dino_idx,), dino_emb)

    # ViT branch: the packed semantic image tokens scattered into the sequence. Padded
    # vit_indexes equal S: they land on an extra row that is cut off, as JAX's mode="drop"
    # scatter drops them (and their rows get no gradient), with no host sync
    if batch.vit_patches is not None and batch.vit_patches.shape[0] > 0:
        vit_emb = qwen_vit.encode_packed(
            model.vit_model, batch.vit_patches, batch.vit_coords, batch.vit_seg, compute_dtype, remat=remat
        )
        seq = torch.cat([seq, seq.new_zeros((1, seq.shape[1]))])
        seq = seq.index_put((batch.vit_indexes.long(),), vit_emb.to(compute_dtype))[:s]

    info = TokenInfo(batch.doc_id, batch.fn_id, batch.noise_id, batch.pos)
    hidden = mot_decoder.decoder_forward_train(
        lm.model, seq, batch.is_geo, batch.position_ids, info,
        geo_start=geo_start, compute_dtype=compute_dtype,
        remat=remat, remat_group=remat_group, remat_inner=remat_inner,
    )

    details: Dict[str, torch.Tensor] = {}

    # --- CE on answer spans, weighted ---
    logits = mot_decoder.lm_head(lm, hidden[batch.ce_indexes.long()], torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch.ce_labels.long()[:, None])[:, 0]
    ce = (nll * batch.ce_weights).sum() / (batch.ce_weights.sum() + 1e-8)
    details["ce"] = ce
    total = ce_weight * ce

    # --- Pi3 losses on the hidden states at the dino rows ---
    dino_hidden = hidden[dino_idx].reshape(n, hw, -1)
    preds = tg.pi3_predict(
        model, dino_hidden, (h, w), cfg, compute_dtype=compute_dtype, remat=remat, view_chunk=head_view_chunk
    )
    pred = {key: None if preds.get(key) is None else preds[key][None]
            for key in ("local_points", "camera_poses", "global_points", "conf")}
    gt = {"world_points": batch.world_points, "point_masks": batch.point_masks, "extrinsics": batch.extrinsics}
    if pred["conf"] is not None:
        gt["conf_target_thresh"] = conf_target_thresh
        sky = batch.sky_masks
        if sky is None:
            with torch.no_grad():
                sky = segformer.predict_sky_mask(model.segformer, batch.dino_images)[None]
        gt["sky_mask"] = sky
    dl, dl_details = losses.pi3_loss(pred, gt, batch.normal_batch_mask)
    details.update(dl_details)
    details["dl"] = dl
    return total + recon_weight * dl, details


# ---------------------------------------------------------------------------
# freezing
# ---------------------------------------------------------------------------

# Parameter-name prefixes owned by the geometry side: the recon towers and
# heads. Inside `language_model.` the geo expert is every name with `_moe_geo`
# plus the LayerScales (ls1, ls2), which scale geo rows only.
_RECON_PREFIXES = (
    "dino_model.", "dino2llm.", "point_decoder.", "point_head.", "camera_decoder.", "camera_head.",
    "global_points_decoder.", "global_point_head.", "conf_decoder.", "conf_head.",
)
_SHARED_LLM = ("language_model.model.embed_tokens.weight", "language_model.lm_head.weight")
_ALWAYS_FROZEN = ("Pi3Loss.",)  # the SegFormer that gives the conf loss its sky masks


def freeze_labels(model: torch.nn.Module, freeze_und: bool, freeze_recon: bool) -> Dict[str, str]:
    """'train' / 'frozen' per parameter name. freeze_und freezes the und
    expert and the semantic ViT; freeze_recon freezes the geo expert and the
    recon towers and heads; the SegFormer is always frozen. The shared trunk
    leaves (token embedding, lm_head) stay trainable."""
    labels = {}
    for name, _ in model.named_parameters():
        if name.startswith(_ALWAYS_FROZEN):
            labels[name] = "frozen"
            continue
        geo = name.startswith(_RECON_PREFIXES) or (
            name.startswith("language_model.") and ("_moe_geo" in name or ".ls1." in name or ".ls2." in name)
        )
        if geo:
            labels[name] = "frozen" if freeze_recon else "train"
        else:
            und = name.startswith("vit_model.") or (name.startswith("language_model.") and name not in _SHARED_LLM)
            labels[name] = "frozen" if und and freeze_und else "train"
    return labels


def apply_freeze(model: torch.nn.Module, freeze_und: bool = False, freeze_recon: bool = False) -> Dict[str, str]:
    """Turn `requires_grad` off on the frozen parameters (no weight gradient
    is ever built for them) and on for the rest; returns the labels."""
    labels = freeze_labels(model, freeze_und, freeze_recon)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
    return labels


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

Schedule = Union[float, Callable[[int], float]]


def warmup_cosine_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                           end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear init -> peak over
    `warmup_steps`, then a cosine to `end_value` at `decay_steps` (counted from
    step 0), constant after."""

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count / warmup_steps
        span = decay_steps - warmup_steps
        frac = min(max(count - warmup_steps, 0), span) / span
        return end_value + (peak_value - end_value) * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


def _factorable(p: torch.Tensor, min_dim: int) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= min_dim and p.shape[-2] >= min_dim


class Optimizer:
    """Global-norm clip, then Adam moments, decoupled weight decay and the
    learning rate, in optax's order:

        g      = g * min(1, clip / ||g||)                 (all trainable leaves together)
        mu     = b1 mu + (1 - b1) g                       (stored as mu_dtype; where a bf16 moment is
                                                           rounded follows optax.adamw with the full
                                                           nu and g2vlm_tpu's code with the factored
                                                           nu: see the branches in `step`)
        nu     = b2 nu + (1 - b2) g^2                     (fp32; or its row / column means)
        u      = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p
        p      = p - lr(t - 1) * u

    With `factored_v`, a leaf whose last two dims are both >= 128 stores nu as
    the means of g^2 over its last and its second-to-last axis (Adafactor's
    factoring: nu ~ row x col / mean(row)), which takes the second moment from
    4 bytes per parameter to almost nothing; smaller leaves keep the full nu.
    Only the parameters given here are touched.
    """

    def __init__(
        self,
        params: List[torch.nn.Parameter],
        learning_rate: Schedule = 1e-4,
        weight_decay: float = 0.05,
        b1: float = 0.9,
        b2: float = 0.95,
        eps: float = 1e-8,
        grad_clip: float = 1.0,
        mu_dtype: Optional[torch.dtype] = None,
        factored_v: bool = False,
        min_dim_size_to_factor: int = 128,
    ):
        self.params = list(params)
        self.lr, self.wd, self.b1, self.b2, self.eps, self.clip = learning_rate, weight_decay, b1, b2, eps, grad_clip
        self.factored_v = factored_v
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in self.params]
        # per leaf: (nu,) full, or (nu_row, nu_col) factored
        self.nu: List[Tuple[torch.Tensor, ...]] = []
        for p in self.params:
            if factored_v and _factorable(p, min_dim_size_to_factor):
                self.nu.append((
                    torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=p.device),
                ))
            else:
                self.nu.append((torch.zeros_like(p, dtype=torch.float32),))

    def learning_rate_at(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' `.grad`; returns the global norm of
        the gradients before clipping."""
        # a trainable leaf the loss never reached (DINOv2's mask token) has a zero
        # gradient and still decays, as under optax
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        grad_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        clip_scale = torch.where(grad_norm < self.clip, torch.ones_like(grad_norm), self.clip / grad_norm)
        lr = self.learning_rate_at(self.count)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g.float() * clip_scale
            if mu.dtype == torch.float32:
                m = mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            elif self.factored_v:  # g2vlm_tpu's factored Adam: fp32 arithmetic, the rounded moment is used
                mu.copy_(mu.float().mul_(self.b1).add_(g, alpha=1.0 - self.b1))
                m = mu.float()
            else:
                # optax.adamw: b1 itself is rounded to mu's dtype (0.9 -> 0.8984375 in bf16) and so
                # is the product b1 * mu; the sum is fp32 and the update uses it unrounded
                b1_stored = torch.tensor(self.b1, dtype=mu.dtype, device=mu.device)
                m = (mu * b1_stored).float().add_(g, alpha=1.0 - self.b1)
                mu.copy_(m)
            g2 = g.square_()
            if len(nu) == 1:
                v_hat = nu[0].mul_(self.b2).add_(g2, alpha=1.0 - self.b2) / bc2
            else:
                row, col = nu
                row.mul_(self.b2).add_(g2.mean(-1), alpha=1.0 - self.b2)
                col.mul_(self.b2).add_(g2.mean(-2), alpha=1.0 - self.b2)
                denom = row.mean(-1, keepdim=True).clamp_min(1e-30)
                v_hat = (row[..., :, None] * col[..., None, :] / denom[..., None]) / bc2
            update = (m / bc1) / v_hat.sqrt_().add_(self.eps)
            update.add_(p, alpha=self.wd)
            p.add_(update.to(p.dtype), alpha=-lr)
        return grad_norm


def make_optimizer(
    model: torch.nn.Module,
    learning_rate: float = 1e-4,
    weight_decay: float = 0.05,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
    schedule: Optional[Callable[[int], float]] = None,
    freeze_und: bool = False,
    freeze_recon: bool = False,
    mu_dtype: Optional[torch.dtype] = None,
    factored_v: bool = False,
) -> Optimizer:
    """Applies the freeze flags to the model and builds the optimizer over
    the parameters left trainable. mu_dtype=torch.bfloat16 stores the first
    moment in bf16 (2 bytes per trainable parameter less); the second moment
    stays fp32, or is factored with `factored_v`."""
    apply_freeze(model, freeze_und, freeze_recon)
    return Optimizer(
        [p for p in model.parameters() if p.requires_grad],
        learning_rate=schedule if schedule is not None else learning_rate,
        weight_decay=weight_decay, b1=b1, b2=b2, grad_clip=grad_clip,
        mu_dtype=mu_dtype, factored_v=factored_v,
    )


# ---------------------------------------------------------------------------
# train state and step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    step: int
    model: tg.G2VLM  # the parameters, updated in place
    optimizer: Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]]  # by parameter name


def init_train_state(model: tg.G2VLM, optimizer: Optimizer, ema: bool = True) -> TrainState:
    ema_params = {n: p.detach().clone() for n, p in model.named_parameters()} if ema else None
    return TrainState(step=0, model=model, optimizer=optimizer, ema_params=ema_params)


def make_train_step(
    cfg: G2VLMConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    ema_decay: float = 0.9999,
    remat: bool = True,
    geo_start: Optional[int] = None,
    head_view_chunk: int = 0,
    remat_group: int = 1,
    dino_remat_group: int = 1,
    remat_inner: bool = True,
):
    """Returns train_step(state, batch) -> (state, metrics). `batch` carries a
    leading batch axis, walked by a Python loop; the loss is the mean over it
    and the gradients accumulate to the gradient of that mean. The state is
    updated in place (parameters, moments, EMA) and returned. Metrics: `loss`,
    `grad_norm` (before clipping) and the loss details, as 0-d tensors on the
    device."""

    def train_step(state: TrainState, batch: TrainBatch):
        model, opt = state.model, state.optimizer
        n = batch.doc_id.shape[0]
        for p in opt.params:
            p.grad = None
        sums: Dict[str, torch.Tensor] = {}
        for i in range(n):
            total, details = train_forward(
                model, batch.map(lambda x: x[i]), cfg, compute_dtype=compute_dtype, remat=remat,
                geo_start=geo_start, head_view_chunk=head_view_chunk, remat_group=remat_group,
                dino_remat_group=dino_remat_group, remat_inner=remat_inner,
            )
            (total / n).backward()
            for key, val in {**details, "loss": total}.items():
                sums[key] = sums.get(key, 0.0) + val.detach() / n
        grad_norm = opt.step()
        if state.ema_params is not None:
            # EMA e*d + p*(1-d) of the trainable parameters; a frozen parameter
            # equals its EMA for ever, so it is left untouched (bitwise)
            with torch.no_grad():
                trainable = {id(p) for p in opt.params}
                for name, p in model.named_parameters():
                    if id(p) in trainable:
                        e = state.ema_params[name]
                        e.mul_(ema_decay).add_(p.detach().to(e.dtype), alpha=1.0 - ema_decay)
        for p in opt.params:
            p.grad = None
        state.step += 1
        metrics = dict(sums)
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step
