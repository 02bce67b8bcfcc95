"""The port's training slice as a whole against the JAX package, on the CPU:
`train/trainer.py::Trainer` over the synthetic data and the Loader, its
checkpoints, and the flagship's run script.

The JAX Trainer itself runs beside the port's (`Trainer(device="cpu")`) at
tests/test_trainer_e2e.py's `TINY` config (hidden 32, 4 heads, 1+2 layers,
12 queries) with dropout 0, on the same synthetic loaders (4 train clips in
2 steps, 4 validation clips in 2 batches, 64x96), from one set of weights
(the port's, bridged by the JAX package's reference converter). The JAX
Trainer's epoch-1 gradient audit is skipped here, which saves its compile:
tests/test_torch_eval.py holds the audit against JAX's. A second pair of
Trainers runs at an init whose encoder softmax does not saturate, and the
port's Trainer runs under bf16 and accumulation. About 95 s alone (four
JAX compiles).
"""
import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from future_od_tpu.data import loader as jax_loader
from future_od_tpu.data.synthetic import SyntheticClipDataset as JaxSyntheticClipDataset
from future_od_tpu.models.build import build_flagship as jax_build_flagship
from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs
from future_od_tpu.train.trainer import Trainer as JaxTrainer
from future_od_tpu.utils.checkpoint_convert import convert_reference_checkpoint
from future_od_tpu.utils.wandb import WandBConfig as JaxWandBConfig

from future_od_tpu_torch.data import loader, nu_scenes
from future_od_tpu_torch.data.synthetic import CATEGORY_DICT, SyntheticClipDataset
from future_od_tpu_torch.models.build import build_flagship, build_tracker_baseline
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.models.tracker import TrackerFuturePredictor
from future_od_tpu_torch.parallel.mesh import make_mesh
from future_od_tpu_torch.runs import _helper, _loader
from future_od_tpu_torch.runs.nusc_spatiotemporal_imu_500ms import build_parser
from future_od_tpu_torch.train.trainer import Trainer
from future_od_tpu_torch.utils.jax_weights import flagship_state_arrays, load_jax_variables
from test_dataset_files import build_nuscenes_archive, install_file_devkits
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    num_classes=2, num_queries=12, hidden_dim=32, enc_layers=1, dec_layers=2,
    dim_feedforward=64, enc_nheads=4, nheads=4, lr=1e-4, lr_backbone=1e-4, dropout=0.0,
)
IMAGE_SIZE = (64, 96)
# Each tolerance is 10x the gap measured between the two Trainers. Step 1's
# loss is equal (gap 0: a few f32 ulps allowed), step 2's differs by 1.58e-5
# relative, the epoch meters (2 train steps, the eval after them) by 2.4e-4.
# Each parameter's update (weights after a step minus the common start)
# against the JAX Trainer's, as rms(ours - theirs) <= UPDATE_RTOL x
# rms(theirs) + UPDATE_ATOL, in units of lr: the worst relative gap was
# 1.92e-2 after step 1 and 3.61e-2 after step 2 (backbone convolutions:
# elements whose gradient is near 0 take AdamW steps of either sign), the
# worst gap of a tensor that barely moves 1.02e-3 lr (decoder key biases).
# At this random init the encoder self-attention's logits span 1.4e5, so its
# softmax is one-hot in f32 and the true gradient of its q and k rows is 0:
# the port's is 1e-21, while JAX's softmax vjp (y.g - y.sum(y.g)) leaves
# 2e-3 of rounding there, which AdamW scales to steps of +-lr. Those rows
# (SATURATED_ROWS) are held apart: the port's must not move (measured 0;
# SATURATED_ATOL is a thousandth of the step a nonzero gradient gives). The
# eval epoch on one set of weights (JAX's final ones in both) differs by
# 6.8e-8 relative. The AP dicts were equal.
STEP_LOSS_RTOL = (1e-7, 1.6e-4)
UPDATE_RTOL, UPDATE_ATOL = (0.193, 0.362), 1.03e-2
_ENCODER_ATTENTION = "_model.separate_encoder.transformer.layers.0.self_attn.attn."
SATURATED_ROWS = {_ENCODER_ATTENTION + "in_proj_weight": 2 * TINY["hidden_dim"],
                  _ENCODER_ATTENTION + "in_proj_bias": 2 * TINY["hidden_dim"]}
SATURATED_ATOL = 1e-3
# At UNSATURATED_PROJ_SCALE every row is compared, the encoder's q and k
# rows too, with the same form of tolerance at 10x the gaps measured: the
# worst relative gap 8.7e-4 after step 1 and 1.18e-3 after step 2, the worst
# gap of a tensor that barely moves 9.7e-4 lr.
UNSATURATED_PROJ_SCALE = 0.01
UNSATURATED_RTOL, UNSATURATED_ATOL = (8.7e-3, 1.2e-2), 9.7e-3
DRIFT_METER_RTOL = 2.4e-3
METER_RTOL = 7e-7
AP_ATOL = 1e-6


def loaders(loader_module, dataset_class):
    train = loader_module.Loader(
        dataset_class(num_samples=4, image_size=IMAGE_SIZE, max_objects=3, seed=1),
        batch_size=2, shuffle=True, num_workers=2)
    val = loader_module.Loader(
        dataset_class(num_samples=4, image_size=IMAGE_SIZE, max_objects=3, seed=2),
        batch_size=2, shuffle=False, seed=loader_module.VAL_SEED, drop_last=False,
        num_workers=2)
    return train, {"val0": val}


def port_model(seed=0):
    """The tiny flagship on the CPU, its zero-init heads randomized."""
    model = build_flagship(SpatioTemporalDETRArgs(**TINY), device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    det, gen = model._model.detector, torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p, std in ((det.bbox_embed.layers[-1].weight, 0.1),
                       (det.bbox_embed.layers[-1].bias, 0.1), (det.class_embed.bias, 1.0)):
            p.copy_(torch.randn(p.shape, generator=gen) * std)
    return model


def port_trainer(tmp_path, model=None, **kw):
    train, val = loaders(loader, SyntheticClipDataset)
    return Trainer(
        model=model or port_model(), detr_args=SpatioTemporalDETRArgs(**TINY),
        train_loader=train, val_loaders=val, checkpoint_path=str(tmp_path / "ckpt"),
        visualization_path=str(tmp_path / "vis"), save_name="run", category_dict=CATEGORY_DICT,
        print_interval=100, device="cpu", **kw)


def recording(step, record, loss_index, params_of):
    """`step` with each call's loss (output `loss_index`) and parameters
    after it (`params_of(output)`, numpy arrays by port name) appended to
    `record`."""
    def wrapper(*args):
        out = step(*args)
        record.append((float(out[loss_index]), params_of(out)))
        return out
    wrapper.steps = getattr(step, "steps", None)
    return wrapper


def port_arrays(model):
    return {k: v.detach().clone().numpy() for k, v in model.state_dict().items()}


def jax_arrays(state):
    return flagship_state_arrays(jax.tree.map(np.asarray, {"params": state.params,
                                                           "frozen": state.frozen}))


@pytest.fixture(scope="module")
def both_trainers(tmp_path_factory):
    """The JAX and the port's Trainer after one epoch: 2 train steps, the
    eval epoch over val0, AP over each; with the common starting weights
    and each step's (loss, weights after it) on both sides."""
    return run_both_trainers(tmp_path_factory.mktemp("trainers"), port_model())


def run_both_trainers(tmp, model, evaluate=True):
    before = port_arrays(model)
    train, val = loaders(jax_loader, JaxSyntheticClipDataset)
    jmodel = jax_build_flagship(JaxArgs(**TINY))
    example = {k: jnp.asarray(v) for k, v in next(iter(train)).items()
               if k in jax_loader.ARRAY_KEYS}
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.key(0)}, example,
                                                deterministic=True))
    variables = convert_reference_checkpoint(
        {k: v.numpy() for k, v in model.state_dict().items()}, shapes, dim=TINY["hidden_dim"])
    jtrainer = JaxTrainer(
        model=jmodel, detr_args=JaxArgs(**TINY), train_loader=train, val_loaders=val,
        checkpoint_path=str(tmp / "jax"), visualization_path=str(tmp / "jax_vis"),
        save_name="run", category_dict=CATEGORY_DICT, print_interval=100,
        checkpoint_epochs=False, wandb_config=JaxWandBConfig(enabled=False),
        variables=jax.tree.map(jnp.asarray, variables))
    jtrainer._grad_audit = lambda data: None
    if not evaluate:
        jtrainer._run_eval = lambda: None
    jsteps, steps = [], []
    jtrainer._train_step = recording(jtrainer._train_step, jsteps, 1,
                                     lambda out: jax_arrays(out[0]))
    jtrainer.train(1)
    trainer = port_trainer(tmp, model=model, checkpoint_epochs=False)
    trainer._train_step = recording(trainer._train_step, steps, 0,
                                    lambda out: port_arrays(model))
    if not evaluate:
        trainer._run_eval = lambda: None
    trainer.train(1)
    return jtrainer, trainer, jsteps, steps, before


def update_gaps(before, ours, theirs):
    """Per parameter (the saturated rows apart): (rms of the difference of
    the two updates, rms of the JAX update), in units of lr; and the largest
    update of the saturated rows in the port, in units of lr."""
    lr, gaps, saturated = TINY["lr"], {}, 0.0
    for name, start in before.items():
        ours_d, theirs_d = ours[name] - start, theirs[name] - start
        if name in SATURATED_ROWS:
            rows = SATURATED_ROWS[name]
            saturated = max(saturated, float(np.abs(ours_d[:rows]).max()) / lr)
            ours_d, theirs_d = ours_d[rows:], theirs_d[rows:]
        gaps[name] = (float(np.sqrt(np.mean(np.square(ours_d - theirs_d)))) / lr,
                      float(np.sqrt(np.mean(np.square(theirs_d)))) / lr)
    return gaps, saturated


def test_train_epoch_tracks_jax(both_trainers):
    jtrainer, trainer, jsteps, steps, before = both_trainers
    assert len(steps) == len(jsteps) == 2 and trainer.step == 2
    for step, ((loss, ours), (jloss, theirs), rtol) in enumerate(
            zip(steps, jsteps, STEP_LOSS_RTOL)):
        np.testing.assert_allclose(loss, jloss, rtol=rtol, err_msg=f"step {step + 1}")
        # each parameter's update after this step against the JAX Trainer's
        gaps, saturated = update_gaps(before, ours, theirs)
        for name, (gap, update) in gaps.items():
            assert gap <= UPDATE_RTOL[step] * update + UPDATE_ATOL, (step + 1, name, gap, update)
        assert saturated <= SATURATED_ATOL, (step + 1, saturated)
    final = port_arrays(trainer._model)
    assert all(np.array_equal(final[k], v) for k, v in steps[-1][1].items())
    want = jax_arrays(jtrainer.state)
    assert all(np.array_equal(want[k], v) for k, v in jsteps[-1][1].items())


def test_unsaturated_epoch_tracks_jax_in_every_row(tmp_path):
    """At an init whose encoder softmax does not saturate (the input
    projection scaled by UNSATURATED_PROJ_SCALE: the logits span about 20,
    not 1.4e5), every row's update, the encoder's q and k rows too, against
    the JAX Trainer's over the epoch's two steps (no eval epoch)."""
    model = port_model()
    with torch.no_grad():
        model._model.separate_encoder.backbone.input_proj.weight.mul_(UNSATURATED_PROJ_SCALE)
    jtrainer, trainer, jsteps, steps, before = run_both_trainers(tmp_path, model,
                                                                 evaluate=False)
    lr = TINY["lr"]
    for step, ((loss, ours), (jloss, theirs)) in enumerate(zip(steps, jsteps)):
        np.testing.assert_allclose(loss, jloss, rtol=STEP_LOSS_RTOL[step])
        for name, start in before.items():
            ours_d, theirs_d = (ours[name] - start) / lr, (theirs[name] - start) / lr
            gap = float(np.sqrt(np.mean(np.square(ours_d - theirs_d))))
            update = float(np.sqrt(np.mean(np.square(theirs_d))))
            assert gap <= UNSATURATED_RTOL[step] * update + UNSATURATED_ATOL, (step + 1, name, gap,
                                                                          update)
    q_and_k = _ENCODER_ATTENTION + "in_proj_weight"
    assert np.abs(steps[-1][1][q_and_k][:2 * TINY["hidden_dim"]]
                  - before[q_and_k][:2 * TINY["hidden_dim"]]).max() > lr


def assert_ap_equal(ours, ap, label):
    assert set(ours) == set(ap)
    for key, value in ap.items():
        assert ours[key].shape == value.shape, (label, key)
        np.testing.assert_array_equal(np.isnan(ours[key]), np.isnan(value))
        np.testing.assert_allclose(ours[key], value, rtol=0, atol=AP_ATOL,
                                   err_msg=f"{label} {key}")


def test_epoch_meters_and_ap_track_jax(both_trainers):
    jtrainer, trainer = both_trainers[:2]
    assert set(trainer._stats) == set(jtrainer._stats)
    for key, meter in jtrainer._stats.items():
        assert len(trainer._stats[key].history) == len(meter.history) == 1, key
        np.testing.assert_allclose(trainer._stats[key].history, meter.history,
                                   rtol=DRIFT_METER_RTOL, atol=1e-12, err_msg=key)
    assert set(trainer._ap_by_mode) == set(jtrainer._ap_by_mode) == {"train", "val0"}
    for mode, ap in jtrainer._ap_by_mode.items():
        assert_ap_equal(trainer._ap_by_mode[mode], ap, mode)


def test_eval_epoch_on_the_same_weights_equals_jax(both_trainers, tmp_path):
    """A port Trainer holding the JAX Trainer's final weights: its eval
    epoch's meters and AP against the JAX Trainer's eval epoch."""
    jtrainer = both_trainers[0]
    trainer = port_trainer(tmp_path)
    load_jax_variables(trainer._model, jax.tree.map(np.asarray, {
        "params": jtrainer.state.params, "frozen": jtrainer.state.frozen}))
    trainer.eval()
    for key, meter in jtrainer._stats.items():
        if key.startswith("val0"):
            np.testing.assert_allclose(trainer._stats[key].avg, meter.history[0],
                                       rtol=METER_RTOL, atol=1e-12, err_msg=key)
    assert_ap_equal(trainer._ap_by_mode["val0"], jtrainer._ap_by_mode["val0"], "val0")


def state_of(trainer):
    return {
        "net": {k: v.clone() for k, v in trainer._model.state_dict().items()},
        "optimizer": trainer._optimizer.state_dict(),
        "epoch": trainer._epoch, "step": trainer.step,
        "stats": {k: m.state_dict() for k, m in trainer._stats.items()},
    }


def assert_equal_trees(a, b, path="state"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            assert_equal_trees(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal_trees(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b or (a != a and b != b), path  # NaN meters match NaN


def test_checkpoint_round_trip_and_resume(tmp_path, capsys):
    trainer = port_trainer(tmp_path, visualization_epochs={1})
    trainer.train(1)
    saved = state_of(trainer)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["run", "run_final"]
    assert len(list((tmp_path / "vis").glob("*.png"))) == 4  # train and val0, 2 images each
    final = torch.load(tmp_path / "ckpt" / "run_final", weights_only=True)
    assert set(final) == {"net", "net_type", "detr_args"}
    blob = torch.load(tmp_path / "ckpt" / "run", weights_only=True)
    assert {"epoch", "net_type", "net", "optimizer", "lr_schedule", "stats",
            "device"} <= set(blob)

    fresh = port_trainer(tmp_path, model=port_model(seed=5))
    assert not torch.equal(fresh._model.state_dict()["_model.detector.class_embed.weight"],
                           saved["net"]["_model.detector.class_embed.weight"])
    fresh.load_checkpoint()
    assert_equal_trees(state_of(fresh), saved)
    capsys.readouterr()
    fresh.train(2)
    assert "Training epochs 2 to 2." in capsys.readouterr().out
    assert fresh._epoch == 2 and fresh.step == 4
    assert len(fresh._stats["train labels loss"].history) == 2


def test_reference_checkpoint_loads(tmp_path):
    """A reference `.pth`'s `net`, and a bare state_dict `.pth.tar`, load
    into the port as they are."""
    source = port_model(seed=3).state_dict()
    torch.save({"net": source, "epoch": 7}, tmp_path / "ref.pth")
    torch.save(source, tmp_path / "bare.pth.tar")
    for name in ("ref.pth", "bare.pth.tar"):
        trainer = port_trainer(tmp_path)
        trainer.load_checkpoint(str(tmp_path / name))
        assert_equal_trees(trainer._model.state_dict(), source)
        assert trainer._epoch == 0


def test_reference_checkpoint_with_objects_needs_trust(tmp_path):
    """A reference file that pickles more than tensors and plain values (the
    reference's stat meters) is refused unless the caller trusts it."""
    source = port_model(seed=3).state_dict()
    torch.save({"net": source, "stats": argparse.Namespace(epoch=7)}, tmp_path / "ref.pth")
    trainer = port_trainer(tmp_path)
    with pytest.raises(ValueError, match="trust_pickle=True"):
        trainer.load_checkpoint(str(tmp_path / "ref.pth"))
    trainer.load_checkpoint(str(tmp_path / "ref.pth"), trust_pickle=True)
    assert_equal_trees(trainer._model.state_dict(), source)


def test_missing_checkpoint_warns(tmp_path, capsys):
    port_trainer(tmp_path).load_checkpoint()
    assert "does not exist" in capsys.readouterr().out


@pytest.mark.parametrize("kw", [dict(mesh=make_mesh(1, 2, devices=["cpu", "cpu"]))])
def test_trainer_refuses_unported_options(tmp_path, kw):
    """A mesh with a model axis (tensor parallelism) waits for ROADMAP.md
    item 4b; data parallelism runs one process a device, so a mesh of two
    devices in this process is refused (tests/test_torch_distributed.py
    trains over ranks)."""
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md Queue 1 item 4b"):
        port_trainer(tmp_path, **kw)
    with pytest.raises(ValueError, match="one process a device"):
        port_trainer(tmp_path, mesh=make_mesh(2, 1, devices=["cpu", "cpu"]))


def test_trainer_runs_a_tracker_eval_epoch(tmp_path):
    """Trainer(tracker=...) evaluates the tracker baseline: each batch's
    past frames detected, the host tracker called on their detections, AP
    aggregated over its extrapolated predictions."""
    calls = []
    tracker = TrackerFuturePredictor("average")

    def counting(p1, p2, offsets):
        calls.append((p1["pred_boxes"].shape, None if offsets is None else offsets.shape))
        return tracker(p1, p2, offsets)
    model = build_tracker_baseline(SpatioTemporalDETRArgs(**TINY), device="cpu")
    trainer = port_trainer(tmp_path, model=model, tracker=counting)
    trainer.eval()
    batches = len(trainer._val_loaders["val0"])
    assert len(calls) == batches
    B = trainer._val_loaders["val0"].batch_size
    assert calls[0] == ((B, TINY["num_queries"], 4), (B, 3))
    assert set(trainer._ap_by_mode) == {"val0"} and trainer.step == 0
    assert np.isfinite(trainer._stats["val0 labels loss"].avg)


@pytest.mark.parametrize("kw", [dict(mixed_precision=True), dict(accum_steps=2)])
def test_trainer_runs_and_resumes_under_the_precision_options(tmp_path, kw, capsys):
    """bf16 and accumulation through the Trainer: the audit, an epoch with
    f32 master weights and AdamW state, and a resume from its checkpoint
    that trains the second epoch bit for bit as the run that went on."""
    trainer = port_trainer(tmp_path, **kw)
    trainer.train(1)
    assert "identically-zero gradient" in capsys.readouterr().out
    assert all(p.dtype == torch.float32 for p in trainer._model.parameters())
    assert all(v.dtype == torch.float32 for s in trainer._optimizer.state.values()
               for v in s.values() if v.ndim)
    saved = state_of(trainer)
    fresh = port_trainer(tmp_path, model=port_model(seed=5), **kw)
    fresh.load_checkpoint()
    assert_equal_trees(state_of(fresh), saved)
    trainer.train(2)
    fresh.train(2)
    assert fresh.step == trainer.step == 4
    assert_equal_trees(state_of(fresh), state_of(trainer))


def test_trainer_checks_freeze_and_device(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="freeze_stem"):
        port_trainer(tmp_path, freeze_backbone_stem=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, val = loaders(loader, SyntheticClipDataset)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(port_model(), SpatioTemporalDETRArgs(**TINY), train, val, str(tmp_path),
                str(tmp_path), "run", CATEGORY_DICT)


# ---------------------------------------------------------------------------
# the run script


def option_table(parser):
    return {opt: (a.default, a.choices, a.type, a.nargs)
            for a in parser._actions for opt in a.option_strings}


def test_script_options_equal_jax(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    from runs._helper import build_base_parser as jax_build_base_parser

    jax_parser = jax_build_base_parser()
    jax_parser.add_argument("--epochs", default=160, type=int)
    assert option_table(build_parser()) == option_table(jax_parser)
    result = subprocess.run(
        [sys.executable, "-m", "future_od_tpu_torch.runs.nusc_spatiotemporal_imu_500ms",
         "--help"], capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert result.returncode == 0, result.stderr[-2000:]
    for option in option_table(jax_parser):
        assert option in result.stdout, option


def test_script_without_cuda_exits_with_the_device_error():
    result = subprocess.run(
        [sys.executable, "-m", "future_od_tpu_torch.runs.nusc_spatiotemporal_imu_500ms",
         "--synthetic", "--debug", "--disable_wandb", "--epochs", "2"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert result.returncode != 0
    assert "torch.cuda.is_available() is False" in result.stderr, result.stderr[-2000:]
    assert "Training epochs" not in result.stdout


def test_path_imports_no_jax_and_no_image_libraries():
    code = (
        "import importlib, pkgutil, sys\n"
        "import future_od_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'optax', 'future_od_tpu', 'cv2', 'PIL', 'torchvision', 'wandb')]\n"
        "assert not bad, bad\n"
        "assert 'future_od_tpu_torch.runs.nusc_spatiotemporal_imu_500ms' in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def script_args(**kw):
    args = build_parser().parse_args(["--synthetic", "--debug"])
    for key, value in kw.items():
        setattr(args, key, value)
    return args


@pytest.mark.parametrize("kw", [dict(mesh_model=2), dict(dist_coordinator="localhost:1"),
                                dict(dist_process_id=0), dict(int8=True)])
def test_get_trainer_refuses_unported_flags(kw):
    """A run's start refuses --mesh_model > 1 (item 4b) by name, and partial
    --dist_* flags with ValueError, as the JAX package's distributed_config
    does; --int8 (ported: the eval scripts' int8 backbone) starts as the JAX
    run does; without the flags it starts one process (no process group)."""
    if "dist_coordinator" in kw or "dist_process_id" in kw:
        with pytest.raises(ValueError, match="partial distributed flags"):
            _helper.start_run(script_args(**kw))
    elif "int8" in kw:
        _helper.start_run(script_args(**kw))
        assert not torch.distributed.is_initialized()
    else:
        with pytest.raises(NotImplementedError, match=r"ROADMAP.md Queue 1 item \d"):
            _helper.start_run(script_args(**kw))
    _helper.start_run(script_args())
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("kw", [dict(loader="grain"), dict(device_normalize=True),
                                dict(synthetic=False)])
def test_loaders_take_the_ported_flags(kw, tmp_path, monkeypatch):
    """The flags the loader functions refused before the datasets were
    ported, each on the fabricated nuScenes archive of
    tests/test_dataset_files.py: worker processes, uint8 video, real data."""
    install_file_devkits(monkeypatch)
    root = build_nuscenes_archive(str(tmp_path))
    args = script_args(**{"synthetic": False, **kw})
    train, val = _loader.get_nusc_loaders((64, 96), [-1.0, -0.5, 0], args,
                                          {"nuscenes_path": root}, 4)
    want = loader.WorkerLoader if kw.get("loader") == "grain" else loader.Loader
    assert type(train) is want and type(val["val0"]) is want
    batch = next(iter(train))
    assert batch["video"].shape == (1, 3, 64, 96, 3)
    assert batch["video"].dtype == (np.uint8 if kw.get("device_normalize") else np.float32)
    assert _helper.category_dict_for(train) == nu_scenes.CATEGORY_DICT


def test_synthetic_loaders_equal_jax(monkeypatch):
    """get_nusc_loaders(--synthetic) builds the JAX function's splits and
    batches: 64 train clips in batches of 8, 16 validation clips in 2s."""
    monkeypatch.syspath_prepend(REPO)
    from runs._loader import get_nusc_loaders as jax_get_nusc_loaders

    args = script_args()
    train, val = _loader.get_nusc_loaders((40, 48), [-1.0, -0.5, 0], args, {}, 8)
    jtrain, jval = jax_get_nusc_loaders((40, 48), [-1.0, -0.5, 0], args, {}, 8)
    for ours, ref in ((train, jtrain), (val["val0"], jval["val0"])):
        assert (len(ours), ours.batch_size, ours.shuffle, ours.seed, ours.drop_last) == (
            len(ref), ref.batch_size, ref.shuffle, ref.seed, ref.drop_last)
        assert len(ours.dataset) == len(ref.dataset)
    assert (len(train), len(val["val0"])) == (8, 8)
    assert _helper.category_dict_for(train) == CATEGORY_DICT
