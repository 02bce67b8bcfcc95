"""drift_base's config trained by the JAX Trainer and the port's Trainer side
by side on the CPU (marked slow: not in tier-1; about 20 min for 18 epochs).

The config of tools/matcher_drift_branched.py's base phase, its transformer
cut to hidden 64 (8 heads, FFN 256, 2 + 3 layers, 32 queries), its images to
64x96, its splits to 128 train and 32 validation samples at batch 16, and
dropout 0 (the two packages' generators cannot draw the same masks). One JAX
init is bridged into the port; both Trainers take the same data order, lr
schedule and clip. Each epoch appends a line to the JSONL file
DRIFT_SIDE_BY_SIDE_OUT (default: the test's temporary directory): both
train losses, the skipped steps, both val AP50s and the parameters'
relative L2 gap.

At the JAX Trainer's first skipped (non-finite) step, the test saves the
state before it and its batch, and holds there: the JAX loss equals the
port's; the port's gradient is finite, as is JAX's eager (op by op)
gradient; the jitted JAX gradient's non-finite leaves are recorded.

    JAX_PLATFORMS=cpu DRIFT_EPOCHS=18 python -m pytest -m slow -s \
        tests/test_torch_drift_side_by_side.py
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

CUT = dict(freeze_stem=False, num_classes=2, num_queries=32, hidden_dim=64, enc_layers=2,
           dec_layers=3, dim_feedforward=256, enc_nheads=8, nheads=8, dropout=0.0)
IMAGE, SAMPLES, VAL, BATCH, LR, MAX_NORM = (64, 96), 128, 32, 16, 3e-4, 0.1


def lr_func(e):
    return min(1.0, (e + 1) / 5)


def loaders(loader_module, dataset_class):
    train = loader_module.Loader(
        dataset_class(num_samples=SAMPLES, num_frames=1, image_size=IMAGE, max_objects=4, seed=1),
        batch_size=BATCH, shuffle=True, num_workers=2)
    val = loader_module.Loader(
        dataset_class(num_samples=VAL, num_frames=1, image_size=IMAGE, max_objects=4, seed=2),
        batch_size=BATCH, seed=loader_module.VAL_SEED, num_workers=2)
    return train, {"val0": val}


def trainers(path):
    from future_od_tpu.data import loader as jax_loader
    from future_od_tpu.data.synthetic import CATEGORY_DICT
    from future_od_tpu.data.synthetic import SyntheticClipDataset as JaxDataset
    from future_od_tpu.models.build import build_single_frame as jax_build
    from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs
    from future_od_tpu.train.trainer import Trainer as JaxTrainer
    from future_od_tpu.utils.wandb import WandBConfig as JaxWandB
    from future_od_tpu_torch.data import loader
    from future_od_tpu_torch.data.synthetic import SyntheticClipDataset
    from future_od_tpu_torch.models.build import build_single_frame
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.train.trainer import Trainer
    from future_od_tpu_torch.utils.jax_weights import load_jax_variables
    from future_od_tpu_torch.utils.wandb import WandBConfig

    common = dict(lr=LR, lr_backbone=LR, max_norm=MAX_NORM, matcher="auction")
    jargs, args = JaxArgs(**CUT, **common), SpatioTemporalDETRArgs(**CUT, **common)
    jmodel = jax_build(jargs, use_imu=False)
    train, val = loaders(jax_loader, JaxDataset)
    example = {k: jnp.asarray(v) for k, v in next(iter(train)).items()
               if k in jax_loader.ARRAY_KEYS}
    variables = jax.jit(lambda: jmodel.init({"params": jax.random.key(0)}, example,
                                            deterministic=True))()
    variables = jax.tree.map(np.asarray, dict(variables))
    kw = dict(lr_func=lr_func, print_interval=1000, checkpoint_epochs=False,
              freeze_backbone_stem=False, seed=0, category_dict=CATEGORY_DICT,
              visualization_path=os.path.join(path, "vis"))
    jax_trainer = JaxTrainer(model=jmodel, detr_args=jargs, train_loader=train, val_loaders=val,
                             checkpoint_path=os.path.join(path, "jax"), save_name="j",
                             wandb_config=JaxWandB(enabled=False),
                             variables=jax.tree.map(jnp.asarray, variables), **kw)
    model = build_single_frame(args, use_imu=False, device="cpu")
    load_jax_variables(model, {k: variables[k] for k in ("params", "frozen")})
    train, val = loaders(loader, SyntheticClipDataset)
    port = Trainer(model=model, detr_args=args, train_loader=train, val_loaders=val,
                   checkpoint_path=os.path.join(path, "port"), save_name="p",
                   wandb_config=WandBConfig(enabled=False), device="cpu", **kw)
    for t in (jax_trainer, port):
        t._grad_audit = lambda data: None
    return jax_trainer, port, jmodel, jargs, args


def first_skipped_step(jax_trainer):
    """Wrap the JAX Trainer's step: the state before its first skipped
    step and that step's batch land in the returned dict."""
    found, step = {}, jax_trainer._train_step

    def wrapper(state, batch, rng):
        before = None if found else dict(
            params=jax.tree.map(np.array, state.params),
            frozen=jax.tree.map(np.array, state.frozen), step=int(state.step))
        out = step(state, batch, rng)
        if not found and float(out[2]["nonfinite_skipped"]) > 0:
            found.update(before, batch={k: np.asarray(v) for k, v in batch.items()},
                         loss=float(out[1]))
        return out
    jax_trainer._train_step = wrapper
    return found


def parameter_gap(jax_trainer, model):
    from future_od_tpu_torch.utils.jax_weights import state_arrays

    jax_state = state_arrays({"params": jax.tree.map(np.asarray, jax_trainer.state.params),
                              "frozen": jax.tree.map(np.asarray, jax_trainer.state.frozen)})
    num = den = 0.0
    for name, p in model.named_parameters():
        a, b = p.detach().double().numpy(), np.asarray(jax_state[name], np.float64)
        num, den = num + ((a - b) ** 2).sum(), den + (b ** 2).sum()
    return float(np.sqrt(num / den))


def at_the_skipped_step(found, jmodel, jargs, args):
    """The JAX loss (jitted) and gradients (jitted and eager), and the
    port's, on the saved state and batch."""
    from future_od_tpu.train.step import _forward_and_loss
    from future_od_tpu_torch.models.build import build_single_frame
    from future_od_tpu_torch.train.step import forward_and_loss, to_device_batch
    from future_od_tpu_torch.utils.jax_weights import load_jax_variables

    cfg = jargs.criterion_config("per level")
    data = {k: jnp.asarray(v) for k, v in found["batch"].items()}
    frozen = jax.tree.map(jnp.asarray, found["frozen"])

    def fwd(p):
        return _forward_and_loss(jmodel, cfg, p, frozen, data, deterministic=False,
                                 dropout_rng=jax.random.key(0), num_boxes=None)
    params = jax.tree.map(jnp.asarray, found["params"])
    out = {}
    for label, fn in (("jit", jax.jit(jax.value_and_grad(fwd, has_aux=True))),
                      ("eager", jax.value_and_grad(fwd, has_aux=True))):
        (loss, _), grads = fn(params)
        flat = jax.tree_util.tree_flatten_with_path(grads)[0]
        out[label] = {"loss": float(loss), "non_finite_leaves": [
            jax.tree_util.keystr(p) for p, g in flat if not np.isfinite(np.asarray(g)).all()]}
    model = build_single_frame(args, use_imu=False, device="cpu")
    load_jax_variables(model, {"params": found["params"], "frozen": found["frozen"]})
    model.train()
    loss, _ = forward_and_loss(model, args.criterion_config(),
                               to_device_batch(found["batch"], torch.device("cpu")))
    loss.backward()
    out["port"] = {"loss": float(loss), "non_finite": [
        n for n, p in model.named_parameters()
        if p.grad is not None and not torch.isfinite(p.grad).all()]}
    return out


@pytest.mark.slow
def test_drift_base_side_by_side(tmp_path):
    epochs = int(os.environ.get("DRIFT_EPOCHS", 18))
    out_path = os.environ.get("DRIFT_SIDE_BY_SIDE_OUT", str(tmp_path / "drift.jsonl"))
    jax_trainer, port, jmodel, jargs, args = trainers(str(tmp_path))
    found = first_skipped_step(jax_trainer)
    port_skipped = []
    with open(out_path, "w") as f:
        for epoch in range(1, epochs + 1):
            jax_trainer.train(epoch)
            port.train(epoch)

            def last(trainer, key):
                return trainer._stats[f"train {key} loss"].history[-1]
            record = {"epoch": epoch, **{
                f"{side}_{key}": last(t, key) for side, t in (("jax", jax_trainer), ("port", port))
                for key in ("labels", "box_l1", "box_giou", "nonfinite_skipped")}}
            record.update(
                jax_val_ap50=[float(v) for v in jax_trainer._ap_by_mode["val0"]["all"][0, :, 0]],
                port_val_ap50=[float(v) for v in port._ap_by_mode["val0"]["all"][0, :, 0]],
                param_rel_gap=parameter_gap(jax_trainer, port._model))
            port_skipped.append(record["port_nonfinite_skipped"])
            f.write(json.dumps(record) + "\n")
            f.flush()
            print(json.dumps(record), flush=True)
        if found:
            at_step = at_the_skipped_step(found, jmodel, jargs, args)
            f.write(json.dumps({"first_jax_skipped_step": found["step"], **at_step}) + "\n")
            print(json.dumps({"first_jax_skipped_step": found["step"], **at_step}), flush=True)
    assert not any(port_skipped)
    if found:
        assert at_step["port"]["loss"] == at_step["jit"]["loss"] == found["loss"]
        assert not at_step["port"]["non_finite"] and not at_step["eager"]["non_finite_leaves"]
        assert at_step["jit"]["non_finite_leaves"]
