"""The port's eval slice against the JAX package, on the CPU: the AP
aggregation (`metrics/od_map.py::aggregate_mean_average_precision`), the eval
step (`train/step.py::make_eval_step`) and the gradient audit
(`make_grad_report`, `dead_param_names`).

The steps run a tiny flagship (the `TINY` config of tests/test_trainer_e2e.py:
hidden 32, 4 heads, 1+2 layers, 12 queries) on a batch of two 64x96
synthetic clips. The port's weights, from a seed, are bridged into the JAX
model by the JAX package's reference converter over `jax.eval_shape` of its
init, so no JAX init is compiled; the detection heads' zero-init last layers
are randomized, so that every head is live. About 35 s alone (two JAX
compiles: the eval step and the gradient report).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from future_od_tpu.metrics.od_map import (
    aggregate_mean_average_precision as jax_aggregate_mean_average_precision,
)
from future_od_tpu.models.build import build_flagship as jax_build_flagship
from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs
from future_od_tpu.train import optimizer as jax_opt
from future_od_tpu.train.step import TrainState
from future_od_tpu.train.step import dead_param_names as jax_dead_param_names
from future_od_tpu.train.step import make_eval_step as jax_make_eval_step
from future_od_tpu.train.step import make_grad_report as jax_make_grad_report
from future_od_tpu.utils.checkpoint_convert import convert_reference_checkpoint

from future_od_tpu_torch.data.loader import collate
from future_od_tpu_torch.data.synthetic import SyntheticClipDataset
from future_od_tpu_torch.metrics.od_map import aggregate_mean_average_precision
from future_od_tpu_torch.models.build import build_flagship
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.train.optimizer import param_labels
from future_od_tpu_torch.train.step import (
    dead_param_names,
    make_eval_step,
    make_grad_report,
)
from future_od_tpu_torch.utils.jax_weights import flagship_state_arrays
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import GRAD_FLOOR, GRAD_TOL

TINY = dict(
    num_classes=2, num_queries=12, hidden_dim=32, enc_layers=1, dec_layers=2,
    dim_feedforward=64, enc_nheads=4, nheads=4, lr=1e-4, lr_backbone=1e-4, dropout=0.0,
)
IMAGE_SIZE = (64, 96)
# AP from the same intermediaries: both sides count the same positives and
# sum in f32 in their own orders; gaps measured 4.8e-7 to 9.5e-7.
AP_ATOL = 1e-6
# The eval step through the random-init ResNet-50 and the transformer in
# f32: loss measured equal, stats within 1.5e-7 relative, confidences 3.3e-7
# (the report's norms: 1.5e-4 of GRAD_TOL's scale in the separate encoder,
# 9.7e-6 in the detector).
STEP_RTOL = 1e-5
CONF_ATOL = 1e-5


def ap_inputs(seed, steps=3, T=10, C=4, S=4, per_step=12):
    """Per-step intermediaries in prepare_od_map_stuffs's layout: C classes
    (the last the generic one), class 1 with no annotations, confidences
    with ties (padded zeros and repeated values)."""
    rng = np.random.default_rng(seed)
    out = [[], [], [], []]
    for _ in range(steps):
        confs = np.round(rng.uniform(size=(C, per_step)), 1).astype(np.float32)
        confs[:, -3:] = 0.0  # padded entries
        out[0].append(np.broadcast_to(confs, (T, C, per_step)).copy())
        positive = rng.uniform(size=(T, C, per_step)) < np.linspace(0.6, 0.1, T)[:, None, None]
        positive[:, 1] = False
        out[1].append(positive)
        sizes = rng.uniform(size=(C, S, per_step)) < 0.5
        sizes[:, 0] = True
        out[2].append(sizes)
        annos = rng.integers(0, 5, size=(C, S)).astype(np.int32)
        annos[1] = 0
        out[3].append(annos)
    return (np.concatenate(out[0], 2), np.concatenate(out[1], 2),
            np.concatenate(out[2], 2), np.stack(out[3], 2))


@pytest.mark.parametrize("seed", range(3))
def test_aggregate_ap_equals_jax(seed):
    inputs = ap_inputs(seed)
    ref = jax_aggregate_mean_average_precision(*inputs)
    out = aggregate_mean_average_precision(*inputs)
    assert set(out) == set(ref)
    assert np.isnan(out["all"][:, 1]).all()
    for key, value in ref.items():
        assert out[key].shape == value.shape, key
        np.testing.assert_array_equal(np.isnan(out[key]), np.isnan(value), err_msg=key)
        np.testing.assert_allclose(out[key], value, rtol=0, atol=AP_ATOL, err_msg=key)


@pytest.fixture(scope="module")
def models():
    """(port model, JAX model, JAX variables, numpy batch) on one set of
    weights."""
    args = SpatioTemporalDETRArgs(**TINY)
    model = build_flagship(args, device="cpu", generator=torch.Generator().manual_seed(0))
    det, gen = model._model.detector, torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p, std in ((det.bbox_embed.layers[-1].weight, 0.1),
                       (det.bbox_embed.layers[-1].bias, 0.1), (det.class_embed.bias, 1.0)):
            p.copy_(torch.randn(p.shape, generator=gen) * std)
    dataset = SyntheticClipDataset(num_samples=2, image_size=IMAGE_SIZE, max_objects=3, seed=1)
    batch = collate([dataset[i] for i in range(2)])
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    jmodel = jax_build_flagship(JaxArgs(**TINY))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0)}, {k: jnp.asarray(v) for k, v in arrays.items()},
        deterministic=True))
    state_dict = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = jax.tree.map(np.asarray, convert_reference_checkpoint(
        state_dict, shapes, dim=TINY["hidden_dim"]))
    return model, jmodel, variables, arrays


def jax_state(variables):
    tx, opt_state = jax_opt.build_optimizer(variables["params"], lr=1e-4, lr_backbone=1e-4)
    return TrainState(variables["params"], variables["frozen"], opt_state, jnp.int32(0))


def test_eval_step_equals_jax(models):
    model, jmodel, variables, data = models
    cfg = JaxArgs(**TINY).criterion_config()
    jloss, jstats, jmap, jout = jax.tree.map(np.asarray, jax.jit(
        jax_make_eval_step(jmodel, cfg))(jax_state(variables),
                                         {k: jnp.asarray(v) for k, v in data.items()}))
    loss, stats, od_map, output = make_eval_step(
        model, SpatioTemporalDETRArgs(**TINY).criterion_config(), device="cpu")(data)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_RTOL)
    assert set(stats) == set(jstats)
    for key, value in jstats.items():
        np.testing.assert_allclose(float(stats[key]), float(value), rtol=STEP_RTOL, atol=1e-7,
                                   err_msg=key)
    confs, positive, sizes, annos = (t.numpy() for t in od_map)
    np.testing.assert_allclose(confs, jmap[0], rtol=0, atol=CONF_ATOL)
    np.testing.assert_array_equal(positive, jmap[1])
    np.testing.assert_array_equal(sizes, jmap[2])
    np.testing.assert_array_equal(annos, jmap[3])
    assert annos.sum() > 0
    for key in ("class_scores", "boxes"):
        assert output[key].shape == jout[key].shape, key


def norms_as_port_names(norms, variables):
    """The JAX report's per-leaf norms under the port's parameter names:
    each leaf becomes an array of its shape whose norm is its norm, the
    weight bridge lays them out (packing q, k and v into one in_proj), and
    each port parameter's norm is read back."""
    filled = jax.tree.map(lambda n, p: np.full(np.shape(p), float(n) / np.sqrt(np.size(p)),
                                               np.float32), norms, variables["params"])
    arrays = flagship_state_arrays({"params": filled, "frozen": variables["frozen"]})
    return {name: float(np.sqrt(np.square(a, dtype=np.float64).sum()))
            for name, a in arrays.items()}


def test_grad_report_equals_jax(models):
    model, jmodel, variables, data = models
    jcfg = JaxArgs(**TINY).criterion_config()
    state = jax_state(variables)
    jnorms = jax.device_get(jax_make_grad_report(jmodel, jcfg)(
        state, {k: jnp.asarray(v) for k, v in data.items()}, jax.random.key(0)))
    jdead = jax_dead_param_names(jnorms, jax_opt.param_labels(state.params, True))
    before = {n: p.grad for n, p in model.named_parameters()}
    norms = make_grad_report(model, SpatioTemporalDETRArgs(**TINY).criterion_config(),
                             device="cpu")(data, 0, 0)
    assert all(p.grad is before[n] for n, p in model.named_parameters())
    labels = param_labels(model, True)
    dead = dead_param_names(norms, labels)
    want = norms_as_port_names(jnorms, variables)
    assert set(norms) == {n for n, _ in model.named_parameters()}
    # a port parameter is dead where every JAX leaf it packs is
    want_dead = [n for n in norms if labels[n] != "frozen" and want[n] == 0.0]
    assert dead == want_dead and len(jdead) >= len(dead) > 0
    biggest = max(want.values())
    for name, norm in norms.items():
        tol = GRAD_TOL[name.split(".")[1]] * max(want[name], GRAD_FLOOR * biggest)
        assert abs(float(norm) - want[name]) <= tol, (name, float(norm), want[name])
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(float(norms[n]) == 0.0 for n in frozen)


def test_eval_step_and_report_default_to_cuda(monkeypatch, models):
    model = models[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SpatioTemporalDETRArgs(**TINY).criterion_config()
    for make in (make_eval_step, make_grad_report):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(model, cfg)
