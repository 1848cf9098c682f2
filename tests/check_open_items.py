"""Two CPU checks of records the port's earlier card runs left open (not
collected by pytest; each prints its numbers):

  python tests/check_open_items.py dense_bf16   # ~3 min, ~6 GB
  python tests/check_open_items.py conf_state   # seconds

dense_bf16: the cut-depth "dense" model of seed 0 at full width, untamed
(chip_smoke.py phase 20's parity model without `_tame_point_heads`), recon
on phase 20's two frames of 294x518 by g2vlm_tpu in fp32 (the reference),
g2vlm_tpu in bf16 and the port in bf16 on the CPU; each output's
max|err| / max|ref| against the reference.

conf_state: the conf stage's optimizer state and EMA at tiny widths hold
every conf decoder and conf head leaf (and nothing of the frozen
SegFormer); then the state of phase 19's G2VLMConfig(visual_und=False,
train_conf_pi3=True) and of phase 10's G2VLMConfig(visual_und=False),
reckoned on the meta device: parameters, trainable parameters and the bytes
of fp32 masters, EMA, gradients, a bf16 first moment and the factored second
moments.
"""

import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def dense_bf16():
    import jax
    import jax.numpy as jnp

    from g2vlm_tpu import config as jconfig
    from g2vlm_tpu.inference.pipeline import G2VLMPipeline as JaxPipeline
    from g2vlm_tpu.models import g2vlm as jg
    from g2vlm_tpu_torch.config import G2VLMConfig, cut_depth_config
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
    from g2vlm_tpu_torch.weights import build_model

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(8)
    cfg = G2VLMConfig()
    cut = cut_depth_config(dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, layer_module="dense")), 2)
    jcut = jconfig.G2VLMConfig(**{
        f.name: getattr(cut, f.name) for f in dataclasses.fields(cut)
        if f.name not in ("llm", "vit", "dino", "pi3", "dinov3")},
        llm=jconfig.LLMConfig(**dataclasses.asdict(cut.llm)), vit=jconfig.VitConfig(**dataclasses.asdict(cut.vit)),
        dino=jconfig.DinoConfig(**dataclasses.asdict(cut.dino)),
        pi3=jconfig.Pi3HeadConfig(**dataclasses.asdict(cut.pi3)))
    ids = dict(bos_token_id=1, eos_token_id=2, start_of_image=3, end_of_image=4)
    frames = np.random.default_rng(1).integers(0, 256, (2, 294, 518, 3), dtype=np.uint8)
    model = build_model(cut, device="cpu", dtype=torch.float32, seed=0)
    params = jg.params_from_torch(model.state_dict(), jcut)
    out = {}
    for tag, dt in (("jax_fp32", jnp.float32), ("jax_bf16", jnp.bfloat16)):
        p = jax.tree.map(lambda a: jnp.asarray(a, dt), params)
        got = JaxPipeline(p, jcut, new_token_ids=ids, compute_dtype=dt).recon_from_frames(frames)
        out[tag] = {k: np.asarray(got[k], np.float32) for k in ("local_points", "global_points", "points",
                                                                  "camera_poses")}
    bf16 = build_model(cut, device="cpu", dtype=torch.bfloat16, seed=None)
    bf16.load_state_dict(model.state_dict())
    got = G2VLMPipeline(bf16, cut, new_token_ids=ids).recon_from_frames(frames)
    out["port_bf16"] = {k: got[k].float().numpy() for k in out["jax_fp32"]}
    ref = out["jax_fp32"]
    for tag in ("jax_bf16", "port_bf16"):
        errs = {k: float(np.abs(out[tag][k] - r).max() / np.abs(r).max()) for k, r in ref.items()}
        print(f"[dense_bf16] {tag} against jax_fp32, max|err|/max|ref|: "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    z = np.log(np.maximum(np.abs(ref["local_points"][..., 2]), 1e-30))
    print(f"[dense_bf16] jax_fp32 local depth: log|z| in [{z.min():.2f}, {z.max():.2f}]")


def _reckon(cfg, label):
    from g2vlm_tpu_torch.train import trainer
    from g2vlm_tpu_torch.weights import build_model

    with torch.device("meta"):
        model = build_model(cfg, device="meta", dtype=torch.float32, seed=None)
    labels = trainer.freeze_labels(model, freeze_und=True, freeze_recon=False)
    params = dict(model.named_parameters())
    train = [p for n, p in params.items() if labels[n] == "train"]
    n_all, n_train = sum(p.numel() for p in params.values()), sum(p.numel() for p in train)
    factored = [p for p in train if trainer._factorable(p, 128)]
    nu = sum(p.shape[:-1].numel() + (p.shape[:-2] + p.shape[-1:]).numel() for p in factored)
    nu += sum(p.numel() for p in train if not trainer._factorable(p, 128))
    parts = dict(masters=4 * n_all, ema=4 * n_all, grads=4 * n_train, mu_bf16=2 * n_train, nu=4 * nu)
    total = sum(parts.values())
    print(f"[conf_state] {label}: {n_all / 1e9:.3f} B parameters, {n_train / 1e9:.3f} B trainable; state "
          + ", ".join(f"{k} {v / 2**30:.2f} GiB" for k, v in parts.items()) + f"; total {total / 2**30:.2f} GiB")
    return total


def conf_state():
    from g2vlm_tpu_torch.config import G2VLMConfig, tiny_test_config
    from g2vlm_tpu_torch.train import trainer
    from g2vlm_tpu_torch.weights import build_model

    cfg = dataclasses.replace(tiny_test_config(visual_und=False), train_conf_pi3=True)
    model = build_model(cfg, device="cpu", seed=0)
    opt = trainer.make_optimizer(model, freeze_und=True, factored_v=True, mu_dtype=torch.bfloat16)
    state = trainer.init_train_state(model, opt, ema=True)
    in_opt = {id(p) for p in opt.params}
    conf = [n for n, _ in model.named_parameters() if n.startswith(("conf_decoder.", "conf_head."))]
    seg = [n for n, _ in model.named_parameters() if n.startswith("Pi3Loss.")]
    named = dict(model.named_parameters())
    assert conf and all(id(named[n]) in in_opt and n in state.ema_params for n in conf)
    assert seg and not any(id(named[n]) in in_opt for n in seg)
    print(f"[conf_state] tiny: all {len(conf)} conf decoder / head leaves in the optimizer and the EMA; "
          f"none of the {len(seg)} SegFormer leaves in the optimizer")
    conf_bytes = _reckon(dataclasses.replace(G2VLMConfig(visual_und=False), train_conf_pi3=True), "phase 19")
    base_bytes = _reckon(G2VLMConfig(visual_und=False), "phase 10")
    print(f"[conf_state] phase 19's state is {(conf_bytes - base_bytes) / 2**30:.2f} GiB over phase 10's")


if __name__ == "__main__":
    {"dense_bf16": dense_bf16, "conf_state": conf_state}[sys.argv[1]]()
