"""The port's training and eval scripts on the CPU at a tiny config: each
script's `main()` runs whole (the Trainer, its grad audit, both stages,
checkpoints, the eval epoch and AP), with the flagship built tiny (hidden 32,
4 heads, 1+2 layers, 12 queries, `TINY`), the stages at (48, 64) and
(64, 96), the Trainer on the CPU, and real data from the fabricated
nuScenes/nuImages archives of tests/test_dataset_files.py (its file-boundary
devkit stubs; the archive's one scene is copied to every split's version,
and its sweeps retimed to reach the 50 and 100 ms offsets). The
single-frame script trains `build_single_frame` at the same tiny widths
(its debug frames at (64, 96)), and the tracker eval loads that script's
final checkpoint into `build_tracker_baseline`.
The eval scripts load a fabricated checkpoint. The serving script
(`runs/serve.py`) serves the tiny flagship on the CPU at 64x96, from random
weights and from a fabricated checkpoint, and over a 2-device CPU grid. About 35 s alone.
"""
import dataclasses
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from future_od_tpu_torch.models.build import build_flagship, build_single_frame, build_tracker_baseline
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.parallel.mesh import make_mesh
from future_od_tpu_torch.data.synthetic import SyntheticClipDataset
from future_od_tpu_torch.runs import _helper, _loader, _model
from future_od_tpu_torch.runs import nuim_single_frame as single_frame
from future_od_tpu_torch.runs import nuim_spatiotemporal_imu as nuim
from future_od_tpu_torch.runs import nusc_spatiotemporal_imu_250ms as nusc250
from future_od_tpu_torch.runs import nusc_spatiotemporal_imu_500ms as nusc500
from future_od_tpu_torch.runs import nusc_spatiotemporal_imu_prevframe as prevframe
from future_od_tpu_torch.runs import serve
from future_od_tpu_torch.runs.config import config
from future_od_tpu_torch.runs.eval import _common
from future_od_tpu_torch.runs.eval import nuim_spatiotemporal_imu_eval as nuim_eval
from future_od_tpu_torch.runs.eval import nusc_50ms_attendprev_decoder_eval as eval50
from future_od_tpu_torch.runs.eval import nusc_100ms_attendprev_decoder_eval as eval100
from future_od_tpu_torch.runs.eval import nusc_250ms_attendprev_decoder_eval as eval250
from future_od_tpu_torch.runs.eval import nusc_500ms_attendprev_decoder_eval as eval500
from future_od_tpu_torch.runs.eval import nusc_tracker_baseline_eval as tracker_eval
from future_od_tpu_torch.train import trainer as trainer_module
from future_od_tpu_torch.train.step import make_tracker_eval_step
from future_od_tpu_torch.utils.checkpoint import save_checkpoint
from test_dataset_files import build_nuimages_archive, build_nuscenes_archive, install_file_devkits
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(num_queries=12, hidden_dim=32, enc_layers=1, dec_layers=2, dim_feedforward=64,
            enc_nheads=4, nheads=4)


def tiny_model(args, detr_args, store_attention=False):
    del args, store_attention
    return build_flagship(dataclasses.replace(detr_args, **TINY), device="cpu",
                          generator=torch.Generator().manual_seed(0))


@pytest.fixture
def tiny_runs(tmp_path, monkeypatch):
    """The scripts' environment at the tiny config, with both archives."""
    install_file_devkits(monkeypatch)
    monkeypatch.setattr(sys.modules["nuscenes.utils.splits"], "create_splits_scenes",
                        lambda: {k: ["scene-0001"] for k in ("mini_train", "mini_val", "train",
                                                             "val")})
    nusc = build_nuscenes_archive(str(tmp_path / "nuscenes"))
    # sweeps 50 and 100 ms before the keyframe, for the 50/100 ms evals
    with open(tmp_path / "nuscenes" / "v1.0-mini" / "sample_data.json") as f:
        records = json.load(f)
    key = records[-1]["timestamp"]
    for record, back in zip(records, (1.5, 1.25, 1.0, 0.75, 0.5, 0.25, 0.1, 0.05, 0.0)):
        record["timestamp"] = key - int(back * 1_000_000)
    with open(tmp_path / "nuscenes" / "v1.0-mini" / "sample_data.json", "w") as f:
        json.dump(records, f)
    nuimg = build_nuimages_archive(str(tmp_path / "nuimages"))
    shutil.copytree(tmp_path / "nuscenes" / "v1.0-mini", tmp_path / "nuscenes" / "v1.0-trainval")
    for split in ("train", "val"):
        shutil.copytree(tmp_path / "nuimages" / "v1.0-mini", tmp_path / "nuimages" / f"v1.0-{split}")
    for key, value in (("nuscenes_path", nusc), ("nuimages_path", nuimg),
                       ("checkpoint_path", str(tmp_path / "ckpt")),
                       ("visualization_path", str(tmp_path / "vis"))):
        monkeypatch.setitem(config, key, value)
    monkeypatch.setattr(_model, "build_model", tiny_model)
    monkeypatch.setattr(_helper, "STAGES", (((48, 64), 2), ((64, 96), 2)))
    monkeypatch.setattr(_common, "EVAL_IMAGE_SIZE", (64, 96))
    monkeypatch.setattr(trainer_module, "resolve_device", lambda device=None: torch.device("cpu"))
    return tmp_path


@pytest.mark.parametrize("script,flags", [
    (nusc500, ["--bf16"]),
    (nusc250, ["--accum", "2", "--synthetic"]),
    (prevframe, ["--loader", "grain", "--num_workers", "2"]),
    (nuim, ["--device_normalize"]),
])
def test_training_script_runs(tiny_runs, script, flags, capsys, monkeypatch):
    """Each script on the fabricated files (one clip a split), and with
    --synthetic where a batch of one clip cannot split in two (4 clips)."""
    monkeypatch.setattr(_loader, "SyntheticClipDataset",
                        lambda **kw: SyntheticClipDataset(**{**kw, "num_samples": 4}))
    trainer = script.main(["--debug", "--disable_wandb", "--epochs", "1", *flags])
    out = capsys.readouterr().out
    assert "Starting second training stage" in out and "Finished training!" in out
    assert trainer.step >= 1 and trainer._epoch == 1
    assert set(trainer._ap_by_mode) == {"train", "val0"}
    assert np.isfinite(trainer._stats["train labels loss"].history[-1])
    name = script.__name__.rsplit(".", 1)[1]
    assert (tiny_runs / "ckpt" / f"{name}_final").exists()


def test_prevframe_builds_with_encode_offset(tiny_runs, monkeypatch):
    seen = []
    monkeypatch.setattr(_model, "build_model",
                        lambda args, detr_args: seen.append(detr_args) or tiny_model(args,
                                                                                     detr_args))
    prevframe.main(["--debug", "--disable_wandb", "--epochs", "1", "--no_checkpoints"])
    assert seen[0].encode_offset and seen[0].num_classes == 8
    assert prevframe.OFFSETS == ["prev", "prev", 0] and nusc250.OFFSETS == [-0.5, -0.25, 0]
    assert nuim.lr_func(0) == 1 / 21 and nuim.lr_func(300) == 0.5


@pytest.mark.parametrize("script,encode_offset", [
    (nuim_eval, False), (eval50, True), (eval100, True), (eval250, False), (eval500, False)])
def test_eval_script_on_a_fabricated_checkpoint(tiny_runs, script, encode_offset):
    detr_args = SpatioTemporalDETRArgs(num_classes=8, encode_offset=encode_offset)
    net = tiny_model(None, detr_args).state_dict()
    for k in net:
        net[k] = net[k] + 0.01 if net[k].is_floating_point() else net[k]
    path = save_checkpoint(str(tiny_runs / "fabricated"), "w6", {
        "net": net, "net_type": "SpatioTemporalDETR", "detr_args": {}})
    trainer = script.main(["--checkpoint", path, "--disable_wandb"])
    loaded = trainer._model.state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in net.items())
    assert trainer._args.encode_offset == encode_offset
    assert "val0" in trainer._ap_by_mode and trainer.step == 0


def test_eval_script_int8(tiny_runs, monkeypatch):
    """--int8 builds the eval script's model with the int8 PTQ backbone (as
    the JAX runs/eval/_common.py does); its eval epoch runs every trunk
    convolution through K8 (the op's plain version on the CPU), 53 calls a
    forward, and gives the AP dict."""
    from future_od_tpu_torch.ops import quant

    calls = []
    original = quant.int8_conv_codes
    monkeypatch.setattr(quant, "int8_conv_codes",
                        lambda *a, **k: calls.append(1) or original(*a, **k))
    net = tiny_model(None, SpatioTemporalDETRArgs(num_classes=8)).state_dict()
    path = save_checkpoint(str(tiny_runs / "fabricated"), "w6", {
        "net": net, "net_type": "SpatioTemporalDETR", "detr_args": {}})
    trainer = eval500.main(["--checkpoint", path, "--disable_wandb", "--int8"])
    assert trainer._args.int8_backbone and not trainer._args.int8_static
    assert trainer._model._model.separate_encoder.backbone.body.int8
    assert calls and len(calls) % 53 == 0
    assert "val0" in trainer._ap_by_mode and trainer.step == 0


def tiny_builder(build):
    return lambda detr_args, use_imu=False: build(dataclasses.replace(detr_args, **TINY),
                                                  use_imu=use_imu, device="cpu")


def test_single_frame_script_then_tracker_eval(tiny_runs, monkeypatch, capsys):
    """The single-frame script trains on the fabricated nuImages files and
    writes its final checkpoint; the tracker eval loads it (the two trees
    are one) and runs its eval epoch with the host tracker on the 3-frame
    nuScenes clips."""
    monkeypatch.setattr(single_frame, "build_single_frame", tiny_builder(build_single_frame))
    monkeypatch.setattr(single_frame, "DEBUG_IMAGE_SIZE", (64, 96))
    trainer = single_frame.main(["--debug", "--disable_wandb", "--epochs", "1"])
    assert "Finished training!" in capsys.readouterr().out
    assert trainer.step >= 1 and set(trainer._ap_by_mode) == {"train", "val0"}
    assert trainer._train_loader.dataset[0]["video"].shape[0] == 1  # offsets [0]
    final = tiny_runs / "ckpt" / "nuim_single_frame_final"
    assert final.exists()

    monkeypatch.setattr(tracker_eval, "build_tracker_baseline",
                        tiny_builder(build_tracker_baseline))
    monkeypatch.setenv("FUTURE_OD_TRACKER_DIM_EXTRAPOLATION", "linear")
    seen = []
    monkeypatch.setattr(trainer_module, "make_tracker_eval_step",
                        lambda *a, **k: seen.append(a[2]) or make_tracker_eval_step(*a, **k))
    evaluated = tracker_eval.main(["--checkpoint", str(final), "--disable_wandb"])
    loaded = evaluated._model.state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in trainer._model.state_dict().items())
    assert seen[0]._dim_extrapolation == "linear"
    assert "val0" in evaluated._ap_by_mode and evaluated.step == 0
    assert evaluated._val_loaders["val0"].dataset[0]["video"].shape[0] == 3


def test_single_frame_debug_config_is_the_jax_scripts():
    args = single_frame.build_parser().parse_args(["--debug", "--synthetic"])
    detr = single_frame.detr_args_for(args)
    assert (detr.hidden_dim, detr.enc_nheads, detr.nheads, detr.enc_layers, detr.dec_layers,
            detr.dim_feedforward, detr.num_queries, detr.num_classes) == (64, 4, 4, 2, 2, 128,
                                                                          16, 2)
    assert single_frame.DEBUG_IMAGE_SIZE == (128, 192) and single_frame.DEBUG_BATCH == 2
    full = single_frame.detr_args_for(single_frame.build_parser().parse_args([]))
    assert (full.hidden_dim, full.num_queries, full.num_classes) == (256, 128, 8)
    assert single_frame.IMAGE_SIZE == (448, 800) and single_frame.BATCH == 32
    assert single_frame.OFFSETS == [0] and tracker_eval.OFFSETS == [-1.0, -0.5, 0]


SERVE_ARGV = ["--img_size", "64", "96", "--streams", "4", "--max_batch", "2", "--rounds", "2"]
SERVE_KEYS = {"clips_per_sec", "clips", "latency_ms_p50", "latency_ms_p95", "latency_ms_p99",
              "dispatches", "frames", "pad_fraction", "active_streams"}


@pytest.mark.parametrize("flags", [[], ["--bf16", "--device_normalize"]])
def test_serve_script_prints_the_jax_line(monkeypatch, capsys, flags):
    """runs/serve.py's main() with the flagship built tiny on the CPU (f32;
    bf16 on uint8 frames): the JAX script's JSON keys; every stream past
    its warm-up yields a clip a round, in full batches."""
    monkeypatch.setattr(serve, "build_flagship", lambda detr_args: tiny_model(None, detr_args))
    line = serve.main(SERVE_ARGV + flags)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line and set(line) == SERVE_KEYS
    assert line["clips"] == 4 * 2 and line["pad_fraction"] == 0
    assert line["active_streams"] == 4 and line["frames"] == 4 * (2 + 2)


def test_serve_script_builds_from_the_checkpoint(tmp_path, monkeypatch, capsys):
    """--checkpoint serves the architecture the checkpoint was trained with
    (its detr_args: hidden 32 here, which the CLI's default model could not
    load), with its weights; a checkpoint of another net is refused."""
    built = []
    monkeypatch.setattr(serve, "build_flagship", lambda detr_args: built.append(detr_args) or
                        build_flagship(detr_args, device="cpu"))
    detr_args = dataclasses.replace(SpatioTemporalDETRArgs(num_classes=3), **TINY)
    net = tiny_model(None, detr_args).state_dict()
    blob = {"net": net, "net_type": "SpatioTemporalDETR", "detr_args": dataclasses.asdict(
        detr_args)}
    save_checkpoint(str(tmp_path), "served_final", blob)
    line = serve.main(["--checkpoint", "served_final", "--checkpoint_dir", str(tmp_path),
                       "--bf16", *SERVE_ARGV])
    out = capsys.readouterr().out
    assert "model architecture from checkpoint meta" in out
    assert "loaded checkpoint served_final" in out
    assert built == [detr_args] and line["clips"] == 8
    save_checkpoint(str(tmp_path), "other_final", dict(blob, net_type="TrackerBaseline"))
    with pytest.raises(ValueError, match="TrackerBaseline"):
        serve.main(["--checkpoint", "other_final", "--checkpoint_dir", str(tmp_path),
                    *SERVE_ARGV])
    with pytest.raises(SystemExit, match="not found"):
        serve.main(["--checkpoint", "missing", "--checkpoint_dir", str(tmp_path)])


def test_serve_script_mesh_waits_for_parallel(monkeypatch, capsys):
    """--mesh_data 2 serves over a 2-device mesh (here a grid listing the
    CPU twice): the streams spread over both devices, every clip comes
    back; on a machine without 2 cards, make_mesh asserts, as the JAX
    script's does."""
    monkeypatch.setattr(serve, "build_flagship", lambda detr_args: tiny_model(None, detr_args))
    with pytest.raises(AssertionError, match="need 2x1 devices"):
        serve.main(SERVE_ARGV + ["--mesh_data", "2"])
    monkeypatch.setattr(serve, "make_mesh", lambda num_data, num_model: make_mesh(
        num_data, num_model, devices=["cpu"] * num_data))
    line = serve.main(SERVE_ARGV + ["--mesh_data", "2"])
    assert "serving over a 2-chip data mesh" in capsys.readouterr().out
    # a device's share (one row) dispatches as soon as one of its 2 streams
    # has a frame, the other device's share padded: as the JAX server does
    assert line["clips"] == 4 * 2 and line["pad_fraction"] == 0.5
    assert line["active_streams"] == 4 and line["frames"] == 4 * (2 + 2)


def test_serve_script_help_lists_the_jax_flags():
    text = serve.build_parser().format_help()
    for flag in ("--checkpoint", "--checkpoint_dir", "--streams", "--max_batch", "--max_streams",
                 "--img_size", "--num_classes", "--clip_frames", "--rounds", "--bf16",
                 "--device_normalize", "--mesh_data"):
        assert flag in text, flag
