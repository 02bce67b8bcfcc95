"""The port's learning-loop tools (`future_od_tpu_torch/tools/`:
overfit_probe, future_overfit_probe, synthetic_convergence,
matcher_drift_branched, quant_ap_check, noise_ap_check) against the JAX
tools on the CPU:

- each tool's flags, model config, datasets, loaders and Trainer arguments
  equal the JAX tool's field by field, read from the JAX tool's source (the
  JAX probes train at import, so no JAX tool is imported here);
- every tool's `--check` run, matcher_drift_branched's writing the
  checkpoint that quant_ap_check and noise_ap_check then evaluate;
- the probe's config for its first two steps against the JAX train step,
  at 64x96 with dropout 0 (the two packages draw different dropout);
- quant_ap_check's JSON keys equal the JAX tool's, from its own main() over
  a stubbed evaluation;
- noise_ap_check's seed equal to JAX's expression, saturation and NaN
  included, and its noise's relative rms equal to `rel`.

- int8_ranges (no JAX counterpart): its `--check` run on that checkpoint,
  its range record and the ranges its hooks take.

About 60 s alone (one JAX train-step compile, seven tool runs).
"""
import ast
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from future_od_tpu.data.loader import Loader as JaxLoader
from future_od_tpu.data.loader import collate as jax_collate
from future_od_tpu.data.synthetic import SyntheticClipDataset as JaxSyntheticClipDataset
from future_od_tpu.models import build as jax_build
from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs
from future_od_tpu.train import optimizer as jax_opt
from future_od_tpu.train.step import TrainState
from future_od_tpu.train.step import make_train_step as jax_make_train_step

from future_od_tpu_torch.data.loader import Loader
from future_od_tpu_torch.models.build import build_single_frame
from future_od_tpu_torch.tools import _convergence as conv
from future_od_tpu_torch.tools import (
    future_overfit_probe,
    int8_ranges,
    matcher_drift_branched,
    noise_ap_check,
    overfit_probe,
    quant_ap_check,
    synthetic_convergence,
)
from test_torch_flash_tc_rounding import one_torch_thread  # noqa: F401 (autouse)
from test_torch_variants import jax_variables, load_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"overfit_probe": overfit_probe, "future_overfit_probe": future_overfit_probe,
         "synthetic_convergence": synthetic_convergence,
         "matcher_drift_branched": matcher_drift_branched, "quant_ap_check": quant_ap_check,
         "noise_ap_check": noise_ap_check}
# flags whose /tmp default the port moves into the checkout, and the port's
# own
OUT_FLAGS = {"--out", "--progress"}
CKPT_TOOLS = {"quant_ap_check", "noise_ap_check", "int8_ranges"}
PORT_FLAGS = {"--check", "--device"}
# The probe's first two steps at 64x96 against JAX's: step 1's losses were
# equal (about one f32 ulp allowed), step 2's 10x the gap measured (1.08e-7
# relative).
PROBE_LOSS_RTOL = (1e-7, 1.1e-6)


SPECIFIED_CALLS = ("SpatioTemporalDETRArgs", "SyntheticClipDataset", "Loader", "Trainer",
                   "WandBConfig", "build_optimizer", "add_argument")


class Expr(str):
    """The source text of a JAX tool's argument that is not a literal."""


def spec(node):
    """A JAX tool's argument as data: literals as values, calls of
    SPECIFIED_CALLS as ("call", name, positional specs, keyword specs),
    dicts as dicts, the rest as its source text (Expr)."""
    try:
        return ast.literal_eval(node)
    except ValueError:
        pass
    name = isinstance(node, ast.Call) and (getattr(node.func, "id", None)
                                           or getattr(node.func, "attr", None))
    if name in SPECIFIED_CALLS:
        return ("call", name, [spec(a) for a in node.args],
                {k.arg: spec(k.value) for k in node.keywords})
    if isinstance(node, ast.Dict):
        return {ast.literal_eval(k): spec(v) for k, v in zip(node.keys, node.values)}
    return Expr(ast.unparse(node))


def jax_tool(name):
    """(calls by function name, {variable: the call assigned to it}) of the
    JAX tool's source."""
    with open(os.path.join(REPO, "tools", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    calls, assigned = {}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            s = spec(node)
            if isinstance(s, tuple):
                calls.setdefault(s[1], []).append(s)
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name) and isinstance(node.value, ast.Call)):
            assigned[node.targets[0].id] = spec(node.value)
    return calls, assigned


def jax_flags(calls):
    return {s[2][0]: s[3].get("default", False if s[3].get("action") == "store_true" else None)
            for s in calls.get("add_argument", [])}


def port_flags(module):
    return {a.option_strings[0]: a.default for a in module.build_parser()._actions
            if a.option_strings and a.option_strings[0] != "-h"}


def resolve(value, env):
    if isinstance(value, Expr):
        return env[value]  # an argument the test does not know fails here
    return value


def jax_object(s, env):
    """Build the JAX args or dataset a spec describes."""
    _, name, args, kw = s
    cls = {"SpatioTemporalDETRArgs": JaxArgs, "SyntheticClipDataset": JaxSyntheticClipDataset}[name]
    return cls(*[resolve(a, env) for a in args], **{k: resolve(v, env) for k, v in kw.items()})


def check_dataset(port_ds, s, env):
    ref = jax_object(s, env)
    assert vars(port_ds).keys() == vars(ref).keys()
    for key, value in vars(ref).items():
        np.testing.assert_array_equal(np.asarray(getattr(port_ds, key)), np.asarray(value),
                                      err_msg=key)
    for key, value in ref[0].items():  # the first sample, bit for bit
        np.testing.assert_array_equal(port_ds[0][key], value, err_msg=key)


def check_loader(port_loader, s, env, assigned):
    assert isinstance(port_loader, Loader) and s[1] == "Loader"
    _, _, args, kw = s
    env = dict(env, VAL_SEED=Expr("VAL_SEED"))
    check_dataset(port_loader.dataset, assigned[args[0]], env)
    defaults = JaxLoader.__init__.__defaults__
    names = JaxLoader.__init__.__code__.co_varnames[3:3 + len(defaults)]
    for key, default in zip(names, defaults):
        if key in ("sharding", "device_put"):  # JAX device placement
            continue
        want = resolve(kw.get(key, default), env)
        if want == "VAL_SEED":
            from future_od_tpu.data.loader import VAL_SEED as want
        assert getattr(port_loader, key) == want, key


def check_trainer(kw, s, env, assigned):
    _, _, _, jkw = s
    assert set(kw) - {"device"} == set(jkw), set(kw) ^ set(jkw)
    for key, value in jkw.items():
        if key in ("model", "category_dict"):
            continue
        if key == "detr_args":
            assert dataclasses.asdict(kw[key]) == dataclasses.asdict(
                jax_object(assigned["detr_args"], env))
        elif key == "train_loader":
            check_loader(kw[key], value, env, assigned)
        elif key == "val_loaders":
            assert list(kw[key]) == list(value)
            for mode, loader_spec in value.items():
                check_loader(kw[key][mode], loader_spec, env, assigned)
        elif key == "lr_func":
            assert [kw[key](e) for e in range(8)] == [min(1.0, (e + 1) / 5) for e in range(8)]
        elif key == "wandb_config":
            assert value == ("call", "WandBConfig", [], {"enabled": False})
            assert kw[key].enabled is False
        else:
            assert kw[key] == resolve(value, env), key


class Stop(Exception):
    pass


def recorded(monkeypatch, module, argv):
    """Run a port tool's main(argv) until it builds its Trainer or starts
    its probe, recording the builders' and the Trainer's arguments."""
    seen = {"models": [], "trainers": [], "probes": []}

    def fake_build(args, use_imu=None, device=None, generator=None):
        seen["models"].append((args, use_imu))
        return torch.nn.Linear(1, 1)

    class FakeTrainer:
        def __init__(self, **kw):
            seen["trainers"].append(kw)
            raise Stop

    def fake_probe(*args):
        seen["probes"].append(args)
        raise Stop

    target = quant_ap_check if module is noise_ap_check else module
    for name in ("build_single_frame", "build_flagship"):
        if hasattr(target, name):
            monkeypatch.setattr(target, name, fake_build)
    if hasattr(target, "Trainer"):
        monkeypatch.setattr(target, "Trainer", FakeTrainer)
    monkeypatch.setattr(conv, "run_probe", fake_probe)
    with pytest.raises(Stop):
        module.main(argv)
    return seen


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_flags_equal_jax(name):
    calls, _ = jax_tool(name)
    jax_side, port_side = jax_flags(calls), port_flags(TOOLS[name])
    assert set(port_side) - PORT_FLAGS == set(jax_side)
    for flag, default in jax_side.items():
        if flag in OUT_FLAGS and default.startswith("/tmp/"):
            assert port_side[flag].startswith("checkpoints/"), flag
        elif flag in ("--ckpt",):  # the JAX noise tool's path is absolute
            assert port_side[flag] == "checkpoints/drift_base"
        else:
            assert port_side[flag] == default, flag


@pytest.mark.parametrize("name", ["overfit_probe", "future_overfit_probe"])
def test_probe_config_equals_jax(name, monkeypatch):
    calls, _ = jax_tool(name)
    seen = recorded(monkeypatch, TOOLS[name], ["--device", "cpu"])
    (args, use_imu), = seen["models"]
    (model, probe_args, ds, steps, interval, device), = seen["probes"]
    (args_spec,), (ds_spec,) = calls["SpatioTemporalDETRArgs"], calls["SyntheticClipDataset"]
    assert args is probe_args
    assert dataclasses.asdict(args) == dataclasses.asdict(jax_object(args_spec, {}))
    check_dataset(ds, ds_spec, {})
    assert use_imu is (False if name == "overfit_probe" else None)
    with open(os.path.join(REPO, "tools", f"{name}.py")) as f:
        source = f.read()
    assert f"range({steps + 1})" in source and f"it % {interval} == 0" in source
    (opt_spec,) = calls["build_optimizer"]
    assert {k: v for k, v in opt_spec[3].items()} == dict(
        lr=args.lr, lr_backbone=args.lr_backbone, max_norm=0.1, freeze_stem=False)
    assert device == "cpu"


TRAINER_ENVS = {
    "synthetic_convergence": ([], {"args.lr": 3e-4, "args.samples": 256, "args.batch": 16,
                                   "args.out": "checkpoints"}),
    "matcher_drift_branched": (["--base-only"], {
        "lr": 3e-4, "max_norm": 0.1, "matcher": "auction", "samples": 256, "val_samples": 64,
        "batch": 16, "checkpoint_dir": "checkpoints", "save_name": "drift_base",
        "f'visualization/{save_name}'": "visualization/drift_base"}),
    "quant_ap_check": ([], {"int8": False, "batch": 16, "os.path.dirname(ckpt) or '.'":
                            "checkpoints", "os.path.basename(ckpt)": "drift_base"}),
    "noise_ap_check": ([], {"args.batch": 16, "os.path.dirname(args.ckpt) or '.'": "checkpoints",
                            "os.path.basename(args.ckpt)": "drift_base"}),
}


@pytest.mark.parametrize("name", sorted(TRAINER_ENVS))
def test_trainer_config_equals_jax(name, monkeypatch):
    calls, assigned = jax_tool(name)
    argv, env = TRAINER_ENVS[name]
    seen = recorded(monkeypatch, TOOLS[name], argv + ["--device", "cpu"])
    (args, use_imu), = seen["models"]
    (kw,), (trainer_spec,) = seen["trainers"], calls["Trainer"]
    assert use_imu is False and kw["detr_args"] is args and kw["device"] == "cpu"
    check_trainer(kw, trainer_spec, env, assigned)


def test_check_runs_of_every_tool(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # visualization/ lands under tmp
    for name in ("overfit_probe", "future_overfit_probe"):
        assert TOOLS[name].main(["--check"]) == 0
        out = capsys.readouterr().out
        assert out.count("AP50=") == conv.CHECK_STEPS + 1 and out.rstrip().endswith("DONE")
    assert synthetic_convergence.main(["--check", "--out", str(tmp_path / "sc")]) == 0
    assert "FINAL val AP50 per class:" in capsys.readouterr().out
    ckpt, progress = tmp_path / "ck", tmp_path / "progress.jsonl"
    drift = ["--check", "--ckpt-dir", str(ckpt), "--progress", str(progress),
             "--out", str(tmp_path / "drift.json")]
    assert matcher_drift_branched.main(drift + ["--base-only"]) == 0
    assert not (tmp_path / "drift.json").exists()
    lines = [json.loads(line) for line in progress.read_text().splitlines()]
    assert [(r["matcher"], r["epoch"]) for r in lines] == [("base", 1), ("base", 2)]
    assert matcher_drift_branched.main(drift) == 0  # resumes the base, then branches
    results = json.loads((tmp_path / "drift.json").read_text())
    assert results["base_epochs"] == 2 and len(results["hungarian"]["val"]) == 1
    assert set(results["summary"]) >= {"val_windowmean_ap50_delta", "train_final_ap50"}
    quant = tmp_path / "quant.json"
    assert quant_ap_check.main(["--check", "--ckpt", str(ckpt / "drift_base"),
                                "--out", str(quant)]) == 0
    noise = tmp_path / "noise.json"
    assert noise_ap_check.main(["--check", "--ckpt", str(ckpt / "drift_base"),
                                "--out", str(noise)]) == 0
    assert "[noise_ap] injecting rel=0.014" in capsys.readouterr().out
    assert set(json.loads(noise.read_text())) == {"rel", "fit", "val0"}
    assert json.loads(quant.read_text())["int8"]["fit"]["ap50"]
    ranges = tmp_path / "ranges.json"
    assert int8_ranges.main(["--check", "--ckpt", str(ckpt / "drift_base"),
                             "--out", str(ranges)]) == 0
    ranges = json.loads(ranges.read_text())
    assert len(ranges["convs"]) == 53  # the int8 trunk's convolutions
    assert sum(s["convs"] for s in ranges["stages"].values()) == 53
    assert set(ranges["stages"]) == {"stem", "layer1", "layer2", "layer3", "layer4"}
    assert 0 < ranges["feature_rel_err"] < 1


def load_jax_tool(name, monkeypatch):
    """The JAX tool's module, with its persistent compilation cache (a
    directory outside the checkout) left off."""
    from future_od_tpu.utils import cache

    monkeypatch.setattr(cache, "enable_compilation_cache", lambda *args, **kwargs: None)
    spec_ = importlib.util.spec_from_file_location(f"jax_{name}",
                                                   os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


def test_quant_ap_check_json_keys_equal_jax(tmp_path, monkeypatch):
    """Both tools' main() over one stubbed evaluation: the same JSON keys,
    nested, and the same deltas."""
    jax_tool_module = load_jax_tool("quant_ap_check", monkeypatch)

    def fake_evaluate(int8, ckpt, batch, *args, **kw):
        return {mode: {"ap50": [0.5, 0.25 + 0.5 * int8], "map": [0.3, 0.2]}
                for mode in ("fit", "val0")}
    monkeypatch.setattr(jax_tool_module, "evaluate", fake_evaluate)
    monkeypatch.setattr(quant_ap_check, "evaluate", fake_evaluate)
    monkeypatch.setattr("sys.argv", ["quant_ap_check.py", "--out", str(tmp_path / "jax.json")])
    jax_tool_module.main()
    quant_ap_check.main(["--out", str(tmp_path / "port.json")])
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == ref
    assert set(ref) == {"float", "int8", "fit_ap50_abs_delta", "val0_ap50_abs_delta"}


@pytest.mark.parametrize("values", [
    [1.5, -0.25, 3.0], [1e6, 2e6, 1e6], [-3e6, -1e5], [2147483.0, 0.5], [np.nan, 1.0],
    [np.inf], [-np.inf, 1.0], [1e30, -1e30 + 1e24], [0.0]], ids=str)
def test_noise_seed_equals_jax(values):
    """Sums exact in any order (so XLA's and torch's orders agree), each
    through JAX's int32(sum(f32) * 1e3): in range, saturated both ways, NaN."""
    f32 = np.asarray(values, np.float32).reshape(1, -1, 1, 1)
    ref = int((jnp.sum(jnp.asarray(f32)) * 1e3).astype(jnp.int32))
    assert noise_ap_check.noise_seed(torch.from_numpy(f32)) == ref


@pytest.mark.parametrize("rel", [0.014, 0.028])
def test_noise_relative_rms_is_rel(rel):
    g = torch.Generator().manual_seed(0)
    features = torch.randn((4, 4, 6, 128), generator=g) * 3.0 + 1.0
    noisy = noise_ap_check.add_noise(features, rel)
    rms = features.square().mean().sqrt()
    measured = ((noisy - features).square().mean().sqrt() / rms).item()
    assert abs(measured - rel) < 0.02 * rel  # 12288 draws: 0.6 % standard error
    # one seed a batch: the same features give the same noise
    torch.testing.assert_close(noise_ap_check.add_noise(features, rel), noisy, rtol=0, atol=0)
    assert noise_ap_check.add_noise(features.to(torch.bfloat16), rel).dtype == torch.bfloat16


@pytest.mark.parametrize("amax,want", [
    ([0.0, 1.0, 2.0, 8.0], {"amax": 8.0, "outlier_ratio": 4.0}),  # median of the nonzero
    ([3.0, 3.0], {"amax": 3.0, "outlier_ratio": 1.0}),
    ([0.0, 0.0], {"amax": 0.0, "outlier_ratio": 0.0})], ids=str)
def test_int8_ranges_record(amax, want):
    assert int8_ranges.range_record(torch.tensor(amax)) == want


def test_int8_ranges_hook_records_each_trunk_convolution_input():
    """The recorded range of a convolution is its input's per-channel max
    |x|, raised over calls; only the trunk's convolutions are hooked."""
    model = build_single_frame(conv.detr_args(True), device="cpu").eval()
    backbone = model._model.separate_encoder.backbone
    seen = []
    handle = backbone.body.layer2[0].conv2.register_forward_pre_hook(
        lambda m, inputs: seen.append(inputs[0].abs().amax(dim=(0, 2, 3))))
    ranges = {}
    x = torch.from_numpy(conv.dataset(True, 2, seed=1)[0]["video"])
    with torch.no_grad(), int8_ranges.input_ranges(model, ranges):
        backbone(x)
        backbone(x.flip(1) * 2)
    handle.remove()
    assert len(ranges) == 53
    torch.testing.assert_close(ranges["_model.separate_encoder.backbone.layer2.0.conv2"],
                               torch.maximum(*seen), rtol=0, atol=0)


def test_backbone_noise_hook_touches_the_backbone_output_only():
    args = conv.detr_args(True)
    model = build_single_frame(args, device="cpu").eval()
    batch = {k: torch.from_numpy(v[None]) for k, v in conv.dataset(True, 1, seed=1)[0].items()
             if isinstance(v, np.ndarray)}
    backbone = model._model.separate_encoder.backbone
    x = batch["video"][:, 0]
    with torch.no_grad():
        clean = backbone(x)
        with noise_ap_check.backbone_noise(model, 0.5):
            noisy = backbone(x)
        after = backbone(x)
    torch.testing.assert_close(after, clean, rtol=0, atol=0)  # the hook is gone
    torch.testing.assert_close(noisy, noise_ap_check.add_noise(clean, 0.5), rtol=0, atol=0)


def test_probe_first_two_steps_equal_jax():
    """The probe's model config (dropout 0) and loop (`run_probe`: AdamW at
    3e-4 with clip 0.1, the whole trunk trained, seed 1) for steps 0 and 1
    against the JAX probe's jitted train step, from one set of weights, on
    two 64x96 images of the probe's dataset."""
    args = conv.detr_args(False, dropout=0.0)
    ds = conv.dataset(True, 2, overfit_probe.SEED, max_objects=overfit_probe.MAX_OBJECTS)
    jds = JaxSyntheticClipDataset(num_samples=2, num_frames=1, image_size=conv.CHECK_IMAGE_SIZE,
                                  max_objects=3, seed=3)
    data = {k: v for k, v in jax_collate([jds[i] for i in range(2)]).items()
            if k in conv.ARRAY_KEYS}
    jmodel = jax_build.build_single_frame(JaxArgs(**dataclasses.asdict(args)), use_imu=False)
    variables = jax_variables(jmodel, data, seed=11)
    tx, opt_state = jax_opt.build_optimizer(variables["params"], lr=3e-4, lr_backbone=3e-4,
                                            max_norm=0.1, freeze_stem=False)
    state = TrainState(variables["params"], variables["frozen"], opt_state, jnp.int32(0))
    step = jax.jit(jax_make_train_step(jmodel, JaxArgs(**dataclasses.asdict(args))
                                       .criterion_config(), tx))
    ref = []
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    for _ in range(2):
        state, loss, *_ = step(state, jdata, jax.random.key(1))
        ref.append(float(loss))
    model = load_jax_variables(build_single_frame(args, device="cpu"), variables)
    record = conv.run_probe(model, args, ds, steps=1, interval=1, device="cpu")
    assert len(record["losses"]) == 2 and [r["it"] for r in record["lines"]] == [0, 1]
    for i, (loss, want) in enumerate(zip(record["losses"], ref)):
        np.testing.assert_allclose(loss, want, rtol=PROBE_LOSS_RTOL[i], err_msg=f"step {i + 1}")


def test_tools_run_on_the_card_by_default(tmp_path, monkeypatch):
    """Without --device (and without --check) every tool asks for the card:
    with no card visible (patched so, whatever the machine holds, so that no
    tool starts its full run) each raises resolve_device's error, the
    probes' loop too when handed a model built elsewhere."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, module in dict(TOOLS, int8_ranges=int8_ranges).items():
        with pytest.raises(RuntimeError, match="CUDA by default"):
            module.main(["--ckpt", "unused"] if name in CKPT_TOOLS else [])
    with pytest.raises(RuntimeError, match="CUDA by default"):
        conv.run_probe(torch.nn.Linear(1, 1), conv.detr_args(True),
                       conv.dataset(True, 1, seed=3), steps=1, interval=1)
