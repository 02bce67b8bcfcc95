"""The port's mixed precision and exact gradient accumulation against the
JAX package, on the CPU (`train/step.py::make_train_step` with
`mixed_precision` and `accum_steps`).

A tiny flagship (hidden 32, 4 heads, 1+2 layers, 12 queries, dropout 0) on
four 64x96 synthetic clips, the port's weights bridged into the JAX model as
tests/test_torch_eval.py does. The input projection is scaled by PROJ_SCALE,
so that the encoder's softmax does not saturate at init (at scale 1 its
logits span 2e5 and a bf16 rounding anywhere upstream flips whole rows).

bf16 on two packages cannot be bit-equal: XLA and torch round the backbone's
50 bf16 convolutions and their elementwise chains at different points, and
over the random-init ResNet-50 those roundings are as large as bf16 against
f32 itself (backbone gradients: port against JAX 3.2e-2, JAX bf16 against
f32 2.2e-2, port bf16 against f32 3.0e-2). So the check runs in parts:
- the dtype each stage computes in equals JAX's: the backbone in bf16, the
  encoder, the decoder and the heads in f32 over bf16 weights (jnp's
  promotion of the f32 positional encodings and IMU embedding);
- the encoder, decoder, heads and loss from one bf16 backbone output (both
  packages' backbones replaced by the same features), with one injected
  matching: there the port is within 10x the measured gap of JAX, and the
  gradients' gap is below either package's bf16-against-f32 gap;
- the whole bf16 step, matcher included: the loss within 10x the gap, f32
  master parameters and AdamW state, uint8 video left uint8.
Accumulation is exact: K=2 against K=1 and against JAX's
`train_step_accum` at dropout 0, in f32. About 80 s alone (four JAX
compiles; torch's bf16 convolutions are slow on the CPU).
"""
import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from future_od_tpu.models.build import build_flagship as jax_build_flagship
from future_od_tpu.models.decoder import TransformerDecoder as JaxDecoder
from future_od_tpu.models.encoder import TransformerEncoder as JaxEncoder
from future_od_tpu.models.resnet import CDetrBackbone as JaxBackbone
from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs
from future_od_tpu.train import optimizer as jax_opt
from future_od_tpu.train.step import TrainState, _forward_and_loss, _to_half
from future_od_tpu.train.step import make_train_step as jax_make_train_step
from future_od_tpu.utils.checkpoint_convert import convert_reference_checkpoint

from future_od_tpu_torch.data.loader import collate
from future_od_tpu_torch.data.synthetic import SyntheticClipDataset
from future_od_tpu_torch.models.build import build_flagship
from future_od_tpu_torch.models.decoder import TransformerDecoder
from future_od_tpu_torch.models.encoder import TransformerEncoder
from future_od_tpu_torch.models.resnet import CDetrBackbone
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.train import optimizer as opt
from future_od_tpu_torch.train.step import (
    forward_and_loss,
    half_forward_and_loss,
    make_train_step,
)
from future_od_tpu_torch.utils.jax_weights import _adam_states, _merge, flagship_state_arrays
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(
    num_classes=2, num_queries=12, hidden_dim=32, enc_layers=1, dec_layers=2,
    dim_feedforward=64, enc_nheads=4, nheads=4, lr=1e-4, lr_backbone=1e-4, dropout=0.0,
)
PROJ_SCALE = 0.01
IMAGE_SIZE = (64, 96)
# From one bf16 backbone output, with the matches injected: relative gaps
# (||ours - theirs|| / ||theirs|| over a group's gradients) measured
#                      port vs JAX  JAX bf16 vs f32  port bf16 vs f32
#   loss               6.55e-4      6.13e-4          4.5e-5
#   encoder grads      1.42e-2      2.66e-2          2.17e-2
#   detector grads     9.29e-3      1.43e-2          1.16e-2
# Each tolerance is 10x the port-vs-JAX gap, and the gradients' gap must
# stay below both bf16-against-f32 gaps. The loss's does not: JAX's bf16
# loss moves 6.1e-4 from its f32 one where the port's moves 4.5e-5 (the
# decoder's bf16 products over the bf16 query embeddings round at other
# points under XLA's fusion), so the loss is held to its tolerance alone.
SHARED_LOSS_RTOL = 6.6e-3
SHARED_GRAD_RTOL = {"separate_encoder": 0.142, "detector": 0.093}
# The whole bf16 step (backbone included, matcher run): the loss measured
# 1.48e-3 relative from JAX's, the loss stats 6.4e-4 to 1.4e-3, the same
# matches (cardinality, class error and rounds equal).
STEP_LOSS_RTOL = 1.5e-2
# f32 accumulation: K=2 against K=1 and against JAX's K=2 differ by f32
# rounding only (measured 2.1e-7 in the loss; gradients 1.6e-6 relative to
# a group's largest, outputs 8.9e-7).
ACCUM_RTOL = 1e-5
ACCUM_GRAD_RTOL = 1e-4


def cfg():
    return SpatioTemporalDETRArgs(**TINY).criterion_config()


def jcfg():
    return JaxArgs(**TINY).criterion_config()


@pytest.fixture(scope="module")
def models():
    """(port model, JAX model, JAX variables, numpy batch of 4 clips) on one
    set of weights."""
    args = SpatioTemporalDETRArgs(**TINY)
    model = build_flagship(args, device="cpu", generator=torch.Generator().manual_seed(0))
    det, gen = model._model.detector, torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p, std in ((det.bbox_embed.layers[-1].weight, 0.1),
                       (det.bbox_embed.layers[-1].bias, 0.1), (det.class_embed.bias, 1.0)):
            p.copy_(torch.randn(p.shape, generator=gen) * std)
        model._model.separate_encoder.backbone.input_proj.weight.mul_(PROJ_SCALE)
    dataset = SyntheticClipDataset(num_samples=4, image_size=IMAGE_SIZE, max_objects=3, seed=1)
    batch = collate([dataset[i] for i in range(4)])
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    jmodel = jax_build_flagship(JaxArgs(**TINY))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0)}, {k: jnp.asarray(v) for k, v in arrays.items()},
        deterministic=True))
    state_dict = {k: v.numpy() for k, v in model.state_dict().items()}
    # jnp arrays, as the JAX Trainer holds them: numpy leaves would run the
    # frozen BN's arithmetic in numpy, whose promotion turns bf16 to f32
    variables = jax.tree.map(jnp.asarray, convert_reference_checkpoint(
        state_dict, shapes, dim=TINY["hidden_dim"]))
    return model, jmodel, variables, arrays


def fresh_port_model(models):
    model = build_flagship(SpatioTemporalDETRArgs(**TINY), device="cpu")
    model.load_state_dict(models[0].state_dict())
    return model


def injected_matches(active, levels=2, M=TINY["num_queries"], slots=128):
    """One random assignment per level, to the compacted target slots."""
    rng = np.random.default_rng(3)
    idx = np.full((levels, active.shape[0], slots), M, np.int64)
    for a in range(levels):
        for b in range(active.shape[0]):
            n = int(active[b].sum())
            idx[a, b, :n] = rng.choice(M, size=n, replace=False)
    return idx


def relative_gaps(ours, theirs, groups):
    """{group: ||ours - theirs|| / ||theirs||} over the group's tensors."""
    out = {}
    for group in groups:
        names = [n for n in theirs if n.split(".")[1] == group and "backbone" not in n]
        diff = np.concatenate([ours[n].ravel() - theirs[n].ravel() for n in names])
        ref = np.concatenate([theirs[n].ravel() for n in names])
        out[group] = float(np.linalg.norm(diff) / np.linalg.norm(ref))
    return out


def jax_grads_as_port_names(grads, variables):
    return flagship_state_arrays({"params": jax.tree.map(np.asarray, grads),
                                  "frozen": variables["frozen"]})


# ---------------------------------------------------------------------------
# mixed precision


def test_bf16_stages_compute_in_jax_dtypes(models):
    """The backbone, encoder and decoder outputs and the logits have the
    dtypes of the JAX bf16 forward's (flax's captured intermediates)."""
    model, jmodel, variables, data = models
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jdata["video"] = jdata["video"].astype(jnp.bfloat16)
    stages = (JaxBackbone, JaxEncoder, JaxDecoder)
    out, inter = jax.eval_shape(lambda: jmodel.apply(
        _to_half(variables, jnp.bfloat16), jdata, deterministic=False,
        capture_intermediates=lambda mdl, name: isinstance(mdl, stages),
        mutable=["intermediates"]))
    want = [str(jax.tree.leaves(v["__call__"])[0].dtype) for v in (
        inter["intermediates"]["core"]["separate_encoder"]["backbone"],
        inter["intermediates"]["core"]["separate_encoder"]["transformer"],
        inter["intermediates"]["core"]["detector"]["decoder"])]
    want.append(str(out["pred_logits"].dtype))
    assert want == ["bfloat16", "float32", "float32", "float32"]

    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, i, o: seen.append(str((o[0] if isinstance(o, tuple) else o).dtype)[6:]))
        for m in model.modules() if isinstance(m, (CDetrBackbone, TransformerEncoder,
                                                   TransformerDecoder))]
    try:
        model.train()
        batch = {k: torch.as_tensor(v) for k, v in data.items()}
        with torch.no_grad():
            _, (_, logits, _) = half_forward_and_loss(model, cfg(), batch)
    finally:
        for h in hooks:
            h.remove()
    assert seen + [str(logits.dtype)[6:]] == want


def test_bf16_from_one_backbone_output_equals_jax(models, monkeypatch):
    """Encoder, decoder, heads and loss in bf16 from one set of features,
    with one injected matching: the port's loss and gradients against
    JAX's, and that gap against each package's bf16-against-f32 gap."""
    model, jmodel, variables, data = models
    idx = injected_matches(data["active"])
    with torch.no_grad():
        features = model._model.separate_encoder.backbone(
            torch.as_tensor(data["video"][:, :-1]).reshape(-1, *IMAGE_SIZE, 3)).numpy()

    def jax_run(half):
        fixed = jnp.asarray(features, jnp.bfloat16 if half else jnp.float32)

        def backbone_out(next_fun, args, kwargs, context):
            if isinstance(context.module, JaxBackbone) and context.method_name == "__call__":
                return fixed
            return next_fun(*args, **kwargs)

        def loss(params):
            frozen, batch = variables["frozen"], {k: jnp.asarray(v) for k, v in data.items()}
            if half:
                params, frozen = _to_half(params, jnp.bfloat16), _to_half(frozen, jnp.bfloat16)
                batch["video"] = batch["video"].astype(jnp.bfloat16)
            with fnn.intercept_methods(backbone_out):
                return _forward_and_loss(jmodel, jcfg(), params, frozen, batch, False,
                                         pred_idx_all=jnp.asarray(idx, jnp.int32))[0]

        value, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
        return float(value), jax_grads_as_port_names(grads, variables)

    def port_run(half):
        monkeypatch.setattr(CDetrBackbone, "forward", lambda self, x: torch.as_tensor(
            features).to(torch.bfloat16 if half else torch.float32))
        model.train()
        model.zero_grad(set_to_none=True)
        batch = {k: torch.as_tensor(v) for k, v in data.items()}
        loss, _ = (half_forward_and_loss if half else forward_and_loss)(
            model, cfg(), batch, torch.as_tensor(idx))
        loss.backward()
        grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                 if p.grad is not None}
        assert all(p.grad is None or p.grad.dtype == torch.float32 for p in model.parameters())
        model.zero_grad(set_to_none=True)
        return float(loss), grads

    (jl16, jg16), (jl32, jg32) = jax_run(True), jax_run(False)
    (pl16, pg16), (pl32, pg32) = port_run(True), port_run(False)
    groups = tuple(SHARED_GRAD_RTOL)
    ours, jax_bf16, port_bf16 = (relative_gaps(pg16, jg16, groups),
                                 relative_gaps(jg16, jg32, groups),
                                 relative_gaps(pg16, pg32, groups))
    np.testing.assert_allclose(pl16, jl16, rtol=SHARED_LOSS_RTOL)
    for group in groups:
        assert ours[group] <= SHARED_GRAD_RTOL[group], (group, ours)
        assert ours[group] < min(jax_bf16[group], port_bf16[group]), (group, ours, jax_bf16,
                                                                      port_bf16)


def test_bf16_step_equals_jax_and_keeps_f32_masters(models):
    model, jmodel, variables, data = models
    tx, opt_state = jax_opt.build_optimizer(variables["params"], lr=1e-4, lr_backbone=1e-4)
    state = TrainState(variables["params"], variables["frozen"], opt_state, jnp.int32(0))
    _, jloss, jstats, _, _ = jax.jit(jax_make_train_step(jmodel, jcfg(), tx, mixed_precision=True))(
        state, {k: jnp.asarray(v) for k, v in data.items()}, jax.random.key(0))
    model = fresh_port_model(models)
    optimizer = opt.build_optimizer(model, 1e-4, 1e-4)
    step = make_train_step(model, cfg(), optimizer, device="cpu", mixed_precision=True)
    loss, stats, _, output = step(data, 0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_LOSS_RTOL)
    for key in ("labels", "box_l1", "box_giou"):
        np.testing.assert_allclose(float(stats[key]), float(jstats[key]), rtol=STEP_LOSS_RTOL,
                                   err_msg=key)
    assert float(stats["nonfinite_skipped"]) == 0.0
    assert loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers() if b.is_floating_point())
    moments = [v for s in optimizer.state.values() for v in s.values() if v.ndim]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    assert output["boxes"].shape == (4, 1, 1, TINY["num_queries"], 4)


def test_bf16_leaves_uint8_video_uint8(models, monkeypatch):
    """uint8 video reaches the backbone as uint8 (its device_normalize
    branch), f32 video as bf16."""
    model = models[0]
    seen = []
    original = CDetrBackbone.forward
    monkeypatch.setattr(CDetrBackbone, "forward",
                        lambda self, x: seen.append(x.dtype) or original(self, x))
    data = dict(models[3])
    model.train()
    with torch.no_grad():
        for video in (data["video"], np.zeros(data["video"].shape, np.uint8)):
            half_forward_and_loss(model, cfg(), {k: torch.as_tensor(v) for k, v in
                                                 dict(data, video=video).items()})
    assert seen == [torch.bfloat16, torch.uint8]


# ---------------------------------------------------------------------------
# accumulation


@pytest.fixture(scope="module")
def accum_reference(models):
    """JAX's train_step_accum (K=2, f32): loss, stats, clipped gradients
    (optax's first moment after one step, mu = (1 - b1) g) and outputs."""
    _, jmodel, variables, data = models
    tx, opt_state = jax_opt.build_optimizer(variables["params"], lr=1e-4, lr_backbone=1e-4)
    state = TrainState(variables["params"], variables["frozen"], opt_state, jnp.int32(0))
    new_state, loss, stats, od_map, output = jax.tree.map(np.asarray, jax.jit(
        jax_make_train_step(jmodel, jcfg(), tx, accum_steps=2))(
            state, {k: jnp.asarray(v) for k, v in data.items()}, jax.random.key(0)))
    adam = list(_adam_states(new_state.opt_state))
    mu = flagship_state_arrays({"params": _merge([s.mu for s in adam], variables["params"]),
                                "frozen": variables["frozen"]})
    return dict(loss=float(loss), stats=stats, od_map=od_map, output=output,
                grads={n: v / 0.1 for n, v in mu.items()})


def port_step(models, **kw):
    model = fresh_port_model(models)
    optimizer = opt.build_optimizer(model, 1e-4, 1e-4)
    out = make_train_step(model, cfg(), optimizer, device="cpu", **kw)(models[3], 0)
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters() if p.grad is not None}
    return out, grads


def assert_grads_close(ours, theirs):
    biggest = max(np.abs(v).max() for v in theirs.values())
    for name, g in ours.items():
        np.testing.assert_allclose(g, theirs[name], rtol=0, atol=ACCUM_GRAD_RTOL * biggest,
                                   err_msg=name)


def assert_steps_close(ours, loss, stats, od_map, output):
    np.testing.assert_allclose(float(ours[0]), loss, rtol=ACCUM_RTOL)
    for key, value in stats.items():
        np.testing.assert_allclose(float(ours[1][key]), float(value), rtol=ACCUM_RTOL,
                                   atol=1e-7, err_msg=key)
    for o, r in zip(ours[2], od_map):
        if r.dtype == bool or r.dtype.kind == "i":
            np.testing.assert_array_equal(o.numpy(), r)
        else:
            np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=ACCUM_RTOL)
    for key, value in output.items():
        np.testing.assert_allclose(ours[3][key].numpy(), value, rtol=ACCUM_RTOL, atol=1e-4,
                                   err_msg=key)


def test_accum_equals_one_step_and_jax_accum(models, accum_reference):
    (one, one_grads), (two, two_grads) = port_step(models), port_step(models, accum_steps=2)
    ref = accum_reference
    assert set(two[1]) == set(one[1]) == set(ref["stats"])
    # K=2 against K=1: class_error is the mean of the micro-batches' means
    # (logging only, as in JAX), every other stat and the outputs are exact
    assert_steps_close(two, float(one[0]), {k: v.numpy() for k, v in one[1].items()
                                            if k != "class_error"},
                       [t.numpy() for t in one[2]], {k: v.numpy() for k, v in one[3].items()})
    assert_grads_close(two_grads, one_grads)
    # K=2 against JAX's train_step_accum
    assert_steps_close(two, ref["loss"], ref["stats"], ref["od_map"], ref["output"])
    assert_grads_close(two_grads, ref["grads"])
    assert len(two_grads) > 100


def test_accum_holds_one_micro_batch_and_seeds_each(models, monkeypatch):
    """Each forward sees B/K clips, rows k::K, under its own seed."""
    seen = []
    original = forward_and_loss

    def spy(model, criterion_cfg, data, *a, **k):
        seen.append((data["active"].shape[0], torch.initial_seed()))
        return original(model, criterion_cfg, data, *a, **k)

    import future_od_tpu_torch.train.step as step_module
    monkeypatch.setattr(step_module, "forward_and_loss", spy)
    port_step(models, accum_steps=2)
    assert [s[0] for s in seen] == [2, 2] and seen[0][1] != seen[1][1]


def test_accum_refuses_a_batch_it_cannot_split(models):
    model = fresh_port_model(models)
    step = make_train_step(model, cfg(), opt.build_optimizer(model, 1e-4, 1e-4), device="cpu",
                           accum_steps=3)
    with pytest.raises(ValueError, match="not divisible by accum_steps 3"):
        step(models[3], 0)


def test_bf16_with_accum_runs(models):
    (loss, stats, _, output), grads = port_step(models, mixed_precision=True, accum_steps=2)
    assert np.isfinite(float(loss)) and float(stats["nonfinite_skipped"]) == 0.0
    assert all(g.dtype == np.float32 for g in grads.values())
