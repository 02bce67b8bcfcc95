"""The single-frame core, the tracker baseline and its eval, and the shared
modules, in the port against the JAX package on the CPU: `build_single_frame`
at L=1 and L=3, `build_tracker_baseline` at L=1 (one detection) and L=3
(`per_frame_preds`), their parameter trees against JAX's key for key,
`TrackerFuturePredictor` for each box-size mode with and without temporal
offsets, `make_tracker_eval_step`'s loss, stats, AP intermediaries and
output against JAX's on a synthetic batch, with and without its host-matched
split, and `models/shared_modules.py`'s modules with weights.

The models are tests/test_torch_variants.py's tiny ones (its helpers and
tolerances). About 50 s alone (the JAX tracker step's two compiles).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from future_od_tpu.models import build as jax_build
from future_od_tpu.models import shared_modules as jax_shared
from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs
from future_od_tpu.models.tracker import TrackerFuturePredictor as JaxTracker
from future_od_tpu.train.step import TrainState
from future_od_tpu.train.step import make_tracker_eval_step as jax_make_tracker_eval_step

from future_od_tpu_torch.data.loader import collate
from future_od_tpu_torch.data.synthetic import SyntheticClipDataset
from future_od_tpu_torch.models import build
from future_od_tpu_torch.models import shared_modules
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.models.tracker import TrackerFuturePredictor
from future_od_tpu_torch.train.step import make_tracker_eval_step
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)
from test_torch_variants import (
    BOX_ATOL,
    TINY,
    check_tree,
    check_variant,
    jax_variables,
    load_jax_variables,
    variant_fixture,
)

# the tracker on the same detections: numpy f32 on both sides, one solver
TRACKER_ATOL = 1e-6
# the eval step through the tiny model (test_torch_eval.py's bounds)
STEP_RTOL = 1e-5
CONF_ATOL = 1e-5


def single_frame(a, p):
    return jax_build.build_single_frame(a), build.build_single_frame(p, device="cpu")


def tracker(a, p):
    return jax_build.build_tracker_baseline(a), build.build_tracker_baseline(p, device="cpu")


VARIANTS = {"single frame L=1": single_frame, "single frame L=3": single_frame,
            "tracker L=1": tracker, "tracker L=3": tracker}
FRAMES = {"single frame L=1": 1, "single frame L=3": 3, "tracker L=1": 1, "tracker L=3": 3}
variants = variant_fixture(VARIANTS, FRAMES)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_equals_jax(variants, name):
    check_variant(variants, name)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_parameter_tree_is_the_jax_tree(variants, name):
    check_tree(variants, name)


def test_tracker_and_single_frame_share_one_tree(variants):
    """Without the IMU neither has an IMU MLP or egodeep attention, and a
    single-frame checkpoint loads into the tracker baseline."""
    single = variants("single frame L=1")[0].state_dict()
    assert not any("imu_layers" in k or "egodeep" in k for k in single)
    assert sorted(single) == sorted(variants("tracker L=1")[0].state_dict())
    assert variants("tracker L=3")[0].load_state_dict(single, strict=True) is not None


def detections(seed, B=3, M=7, C=4):
    rng = np.random.default_rng(seed)
    pred = lambda: {  # noqa: E731
        "pred_logits": rng.normal(0, 2, (B, M, C)).astype(np.float32),
        "pred_boxes": np.concatenate([rng.uniform(0.2, 0.8, (B, M, 2)),
                                      rng.uniform(0.05, 0.3, (B, M, 2))], -1).astype(np.float32),
    }
    offsets = np.stack([rng.uniform(-1.2, -0.8, B), rng.uniform(-0.6, -0.3, B),
                        np.zeros(B)], 1).astype(np.float32)
    return pred(), pred(), offsets


@pytest.mark.parametrize("dim_mode", [None, "linear", "percentual", "average"])
@pytest.mark.parametrize("with_offsets", [False, True])
def test_tracker_predictor_equals_jax(dim_mode, with_offsets):
    p1, p2, offsets = detections(3)
    offsets = offsets if with_offsets else None
    ref = JaxTracker(dim_mode)(p1, p2, offsets)
    out = TrackerFuturePredictor(dim_mode)(p1, p2, offsets)
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_allclose(out[key], ref[key], atol=TRACKER_ATOL, rtol=1e-6, err_msg=key)


def test_tracker_predictor_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="dim_extrapolation"):
        TrackerFuturePredictor("quadratic")


@pytest.fixture(scope="module")
def tracker_step_case():
    """(port tracker model, JAX model, JAX variables, synthetic batch of two
    3-frame clips at 64x128 with boxes)."""
    dataset = SyntheticClipDataset(num_samples=2, image_size=(64, 128), max_objects=3, seed=4)
    batch = collate([dataset[i] for i in range(2)])
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    args = dict(TINY, num_classes=2)
    jmodel = jax_build.build_tracker_baseline(JaxArgs(**args))
    variables = jax_variables(jmodel, arrays, seed=4)
    port = build.build_tracker_baseline(SpatioTemporalDETRArgs(**args), device="cpu")
    return load_jax_variables(port, variables), jmodel, variables, arrays, args


def test_tracker_eval_step_equals_jax(tracker_step_case):
    check_tracker_eval_step(tracker_step_case, host_matched=False)


def test_tracker_eval_step_host_matched_equals_jax(tracker_step_case):
    """The host-matched split: the exact solver on the host between the
    tracker and the loss, as JAX's make_tracker_eval_step(host_matched=True)."""
    check_tracker_eval_step(tracker_step_case, host_matched=True)


def check_tracker_eval_step(tracker_step_case, host_matched):
    port, jmodel, variables, data, args = tracker_step_case
    cfg = JaxArgs(**args).criterion_config()
    state = TrainState(variables["params"], variables["frozen"], None, jnp.int32(0))
    ref = jax.tree.map(np.asarray, jax_make_tracker_eval_step(
        jmodel, cfg, JaxTracker("linear"), host_matched=host_matched)(
            state, {k: jnp.asarray(v) for k, v in data.items()}))
    out = make_tracker_eval_step(port, SpatioTemporalDETRArgs(**args).criterion_config(),
                                 TrackerFuturePredictor("linear"), host_matched=host_matched,
                                 device="cpu")(data)
    (loss, stats, od_map, output), (jloss, jstats, jmap, jout) = out, ref
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_RTOL)
    assert set(stats) == set(jstats)
    for key, value in jstats.items():
        np.testing.assert_allclose(float(stats[key]), float(value), rtol=STEP_RTOL, atol=1e-7,
                                   err_msg=key)
    assert len(od_map) == len(jmap)
    for mine, theirs in zip(od_map, jmap):
        assert mine.shape == theirs.shape
        np.testing.assert_allclose(mine.numpy().astype(np.float64),
                                   np.asarray(theirs, np.float64), atol=CONF_ATOL)
    for key in ("class_scores", "boxes"):
        assert output[key].shape == jout[key].shape
        np.testing.assert_allclose(output[key].numpy(), jout[key],
                                   atol=CONF_ATOL if key == "class_scores" else BOX_ATOL)


def linear_from(kernel, bias=None):
    """A port nn.Linear holding a flax kernel (in, out) and bias."""
    layer = torch.nn.Linear(*np.shape(kernel), bias=bias is not None)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.asarray(kernel).T.copy()))
        if bias is not None:
            layer.bias.copy_(torch.from_numpy(np.asarray(bias)))
    return layer


@pytest.mark.parametrize("masked", [False, True])
def test_shared_attention_equals_jax(masked):
    rng = np.random.default_rng(5)
    left = rng.normal(size=(2, 5, 12)).astype(np.float32)
    right = rng.normal(size=(2, 7, 10)).astype(np.float32)
    mask = rng.uniform(size=(2, 5, 7)) < 0.7 if masked else None
    jmod = jax_shared.Attention(num_heads=3, head_dim=4)
    variables = jmod.init(jax.random.key(0), left, right, mask)
    ref = jmod.apply(variables, left, right, mask)
    p = jax.tree.map(np.asarray, variables["params"])
    port = shared_modules.Attention(12, 3, 4, context_dim=10)
    port.to_q, port.to_kv = linear_from(p["to_q"]["kernel"]), linear_from(p["to_kv"]["kernel"])
    port.to_out = linear_from(p["to_out"]["kernel"], p["to_out"]["bias"])
    out = port(torch.from_numpy(left), torch.from_numpy(right),
               None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)


def test_shared_geglu_and_wrappers_equal_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    jmod = jax_shared.GEGLU(hidden_dim=8)
    variables = jmod.init(jax.random.key(0), x)
    p = jax.tree.map(np.asarray, variables["params"])
    port = shared_modules.GEGLU(12, 8)
    port.proj = linear_from(p["proj"]["kernel"], p["proj"]["bias"])
    port.out = linear_from(p["out"]["kernel"], p["out"]["bias"])
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jmod.apply(variables, x)), atol=1e-5)
    residual = shared_modules.Residual(port)
    torch.testing.assert_close(residual(torch.from_numpy(x)),
                               torch.from_numpy(x) + port(torch.from_numpy(x)))

    class Counter(torch.nn.Module):
        stateful = True

        def forward(self, x, state):
            return x + 1, (state or 0) + 1
    chain = shared_modules.SequentialWithState([Counter(), torch.nn.Identity(), Counter()])
    out, state = chain(torch.zeros(2), [5, None, None])
    assert out.tolist() == [2.0, 2.0] and state == [6, None, 1]
    assert shared_modules.NoneModule()(1, a=2) is None
    assert shared_modules.ValueFromDict("k")({"k": 3}) == 3
