"""The host-matched steps in the port against the JAX package on the CPU:
`train/step.py::make_host_matched_steps` (the exact solver on the host
between the cost step and the loss) and `make_tracker_eval_step(...,
host_matched=True)` against JAX's `make_host_matched_steps` and
`make_tracker_eval_step(host_matched=True)`, from one set of bridged
weights (a tiny single-frame model and the tracker baseline, ResNet-50,
D=32, dropout 0).

Each side's solved indices are caught by a spy on its host solver (the JAX
`_hungarian_host`, the port's `ops/matching.py::hungarian_host`) and must
be equal; the losses agree to tests/test_torch_trainer.py's STEP_LOSS_RTOL
(step 1, step 2), the stats and the eval step's AP intermediaries as
tests/test_torch_tracker.py bounds them (STEP_LOSS_RTOL below says where
step 1's bound differs). About 40 s alone (three JAX compiles: the cost
step, the grad step and the loss step, eval and tracker sharing them where
they can).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from future_od_tpu.models import build as jax_build
from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs
from future_od_tpu.models.tracker import TrackerFuturePredictor as JaxTracker
from future_od_tpu.ops import matching as jax_matching
from future_od_tpu.train import optimizer as jax_opt
from future_od_tpu.train.step import TrainState
from future_od_tpu.train.step import make_host_matched_steps as jax_make_host_matched_steps
from future_od_tpu.train.step import make_tracker_eval_step as jax_make_tracker_eval_step

from future_od_tpu_torch.data.loader import collate
from future_od_tpu_torch.data.synthetic import SyntheticClipDataset
from future_od_tpu_torch.models import build
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.models.tracker import TrackerFuturePredictor
from future_od_tpu_torch.ops import matching as port_matching
from future_od_tpu_torch.parallel.mesh import make_mesh
from future_od_tpu_torch.train import step as port_step
from future_od_tpu_torch.train.optimizer import build_optimizer
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tracker import CONF_ATOL, STEP_RTOL
from test_torch_trainer import STEP_LOSS_RTOL as TRAINER_STEP_LOSS_RTOL
from test_torch_variants import BOX_ATOL, TINY, jax_variables, load_jax_variables

ARGS = dict(TINY, num_classes=2, num_queries=8)
LR = 1e-4
# The trainer test's bounds on steps 1 and 2; step 1's (1e-7, its measured
# gap 0) is under one f32 ulp at this model's loss of 22.06, where the two
# step-1 losses differ by 2 ulps (1.73e-7 relative): 10x that gap here.
STEP_LOSS_RTOL = (max(TRAINER_STEP_LOSS_RTOL[0], 1.73e-6), TRAINER_STEP_LOSS_RTOL[1])


def batch_of(frames, seed, samples=2, size=(64, 96)):
    dataset = SyntheticClipDataset(num_samples=samples, num_frames=frames, image_size=size,
                                   max_objects=3, seed=seed)
    batch = collate([dataset[i] for i in range(samples)])
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


class Spy:
    """Records each output of a host solver it wraps."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args):
        out = self.fn(*args)
        self.calls.append(np.asarray(out).copy())
        return out


@pytest.fixture(scope="module")
def single_frame_case():
    data = batch_of(1, seed=7)
    jmodel = jax_build.build_single_frame(JaxArgs(**ARGS))
    variables = jax_variables(jmodel, data, seed=7)
    return jmodel, variables, data


def compare_step(out, ref, loss_rtol):
    (loss, stats, od_map, output), (jloss, jstats, jmap, jout) = out, jax.tree.map(np.asarray, ref)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=loss_rtol)
    assert set(stats) == set(jstats)
    for key, value in jstats.items():
        np.testing.assert_allclose(float(stats[key]), float(value), rtol=STEP_RTOL, atol=1e-6,
                                   err_msg=key)
    assert stats["matcher_rounds"] == 0  # exact: no bidding rounds
    for mine, theirs in zip(od_map, jmap):
        np.testing.assert_allclose(mine.numpy().astype(np.float64),
                                   np.asarray(theirs, np.float64), atol=CONF_ATOL)
    for key in ("class_scores", "boxes"):
        np.testing.assert_allclose(output[key].detach().numpy(), jout[key],
                                   atol=CONF_ATOL if key == "class_scores" else BOX_ATOL)


def test_host_matched_train_and_eval_steps_equal_jax(single_frame_case, monkeypatch):
    jmodel, variables, data = single_frame_case
    jax_spy = Spy(jax_matching._hungarian_host)
    monkeypatch.setattr(jax_matching, "_hungarian_host", jax_spy)
    cfg = JaxArgs(**ARGS).criterion_config()  # matcher "auction": the split ignores it
    tx, opt_state = jax_opt.build_optimizer(variables["params"], lr=LR, lr_backbone=LR,
                                            freeze_stem=True)
    state = TrainState(variables["params"], variables["frozen"], opt_state, jnp.int32(0))
    jtrain, jeval = jax_make_host_matched_steps(jmodel, cfg, tx)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    key = jax.random.key(1)

    port_spy = Spy(port_matching.hungarian_host)
    monkeypatch.setattr(port_matching, "hungarian_host", port_spy)
    args = SpatioTemporalDETRArgs(**ARGS)
    model = load_jax_variables(build.build_single_frame(args, device="cpu"), variables)
    optimizer = build_optimizer(model, lr=LR, lr_backbone=LR, freeze_stem=True)
    train, evaluate = port_step.make_host_matched_steps(model, args.criterion_config(),
                                                        optimizer, device="cpu")
    for i in range(2):
        state, *ref = jtrain(state, jdata, key)
        out = train(data, 1)
        assert out[1]["nonfinite_skipped"] == 0.0
        np.testing.assert_array_equal(port_spy.calls[-1], jax_spy.calls[-1])
        # every decoder level x 2 images, the cost slots
        assert port_spy.calls[-1].shape == (ARGS["dec_layers"] * 2, 128)
        compare_step(out, ref, STEP_LOSS_RTOL[i])
    ref = jeval(state, jdata)
    out = evaluate(data)
    np.testing.assert_array_equal(port_spy.calls[-1], jax_spy.calls[-1])
    compare_step(out, ref, STEP_LOSS_RTOL[1])
    assert len(port_spy.calls) == len(jax_spy.calls) == 3


def test_host_matched_eval_only_and_refusals(single_frame_case):
    """Without an optimizer there is no train step (JAX's tx None); a mesh
    with a model axis of two devices in one process is refused, as any mesh
    of several devices in one process (the steps run one rank a device)."""
    jmodel, variables, data = single_frame_case
    args = SpatioTemporalDETRArgs(**ARGS)
    model = load_jax_variables(build.build_single_frame(args, device="cpu"), variables)
    train, evaluate = port_step.make_host_matched_steps(model, args.criterion_config(), None,
                                                        device="cpu")
    assert train is None and np.isfinite(float(evaluate(data)[0]))
    with pytest.raises(ValueError, match="one process a device"):
        port_step.make_host_matched_steps(model, args.criterion_config(), None, device="cpu",
                                          mesh=make_mesh(1, 2, devices=["cpu", "cpu"]))


def test_host_matched_tracker_eval_step_equals_jax(monkeypatch):
    data = batch_of(3, seed=4, size=(64, 128))
    jmodel = jax_build.build_tracker_baseline(JaxArgs(**ARGS))
    variables = jax_variables(jmodel, data, seed=4)
    jax_spy = Spy(jax_matching._hungarian_host)
    monkeypatch.setattr(jax_matching, "_hungarian_host", jax_spy)
    port_spy = Spy(port_matching.hungarian_host)
    monkeypatch.setattr(port_matching, "hungarian_host", port_spy)
    state = TrainState(variables["params"], variables["frozen"], None, jnp.int32(0))
    ref = jax_make_tracker_eval_step(jmodel, JaxArgs(**ARGS).criterion_config(),
                                     JaxTracker("linear"), host_matched=True)(
        state, {k: jnp.asarray(v) for k, v in data.items()})
    args = SpatioTemporalDETRArgs(**ARGS)
    port = load_jax_variables(build.build_tracker_baseline(args, device="cpu"), variables)
    out = port_step.make_tracker_eval_step(port, args.criterion_config(),
                                           TrackerFuturePredictor("linear"), host_matched=True,
                                           device="cpu")(data)
    assert len(port_spy.calls) == len(jax_spy.calls) == 1
    np.testing.assert_array_equal(port_spy.calls[0], jax_spy.calls[0])
    compare_step(out, ref, STEP_RTOL)
