"""The port's tensor parallelism against the JAX package's on the CPU.

- `param_shardings` at a model axis of 2 against the JAX Trainer's
  `param_shardings(params, make_mesh(1, 2))`, leaf for leaf, at the tiny
  flagship and at the flagship's config (`jax.eval_shape` of the JAX init:
  no compile; the port's model built on the meta device): the JAX leaves
  each port parameter is made of are found through the weight bridge
  (`utils/jax_weights.py::state_arrays`) on a tree whose every leaf holds
  its own index.
- One launch of four gloo ranks on a (2, 2) mesh (this file run as a script,
  `python tests/test_torch_tensor_parallel.py --worker RANK WORLD PORT DIR`,
  no JAX there): a data- and tensor-parallel train step of the tiny
  flagship (attention through K4-K6's plain versions on 2 of the 4 heads;
  dropout 0, since each data place draws its own rows' dropout, as in
  the JAX program; tests/test_torch_distributed.py holds the (1, 2) step at
  dropout 0.1) against the port's one-process step, and a Trainer
  epoch built by the run scripts' `get_trainer` with `--mesh_model 2`, whose
  checkpoint a one-process Trainer loads.

About 40 s alone (the four ranks' imports and steps; the JAX side is shape
evaluation only).
"""
import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TINY = dict(num_classes=2, num_queries=8, hidden_dim=32, enc_layers=1, dec_layers=1,
            dim_feedforward=64, enc_nheads=4, nheads=4, lr=1e-4, lr_backbone=1e-4,
            dropout=0.0)
FLAGSHIP = dict(num_classes=8, num_queries=128)
IMAGE_SIZE = (64, 128)
BATCH, RANKS, MODEL = 4, 4, 2
TRAIN_CLIPS, VAL_CLIPS = 8, 4
# The (2, 2) step against the port's one process on the same global batch,
# weights and seed: the loss relative, and each clipped gradient over the
# largest gradient element. Measured 1.2e-7 and 7.6e-5 (the encoder's
# in_proj_weight, whose K5/K6 recompute p from logits near saturation; the
# backbone's convolutions 2.6e-5: one process with packed against unpacked
# projections, the same function, differs by 4.3e-5 there at these
# weights); each tolerance is 10x that.
LOSS_RTOL = 1.2e-6
GRAD_GAP = 7.6e-4


def port_model(state=None, seed=0, **kw):
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs

    model = build_flagship(SpatioTemporalDETRArgs(**{**TINY, **kw}), device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    if state is not None:
        model.load_state_dict(state)
    return model


def first_batch():
    """The first batch of the synthetic train split (numpy)."""
    from future_od_tpu_torch.data.loader import ARRAY_KEYS, Loader
    from future_od_tpu_torch.data.synthetic import SyntheticClipDataset

    loader = Loader(SyntheticClipDataset(num_samples=BATCH, image_size=IMAGE_SIZE,
                                         max_objects=3, seed=1),
                    batch_size=BATCH, shuffle=False, num_workers=1)
    return {k: np.asarray(v) for k, v in next(iter(loader)).items() if k in ARRAY_KEYS}


def one_step(model, data, mesh=None):
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.train.optimizer import build_optimizer
    from future_od_tpu_torch.train.step import make_train_step

    args = SpatioTemporalDETRArgs(**TINY)
    optimizer = build_optimizer(model, args.lr, args.lr_backbone, args.weight_decay,
                                args.max_norm)
    step = make_train_step(model, args.criterion_config(), optimizer, device="cpu", mesh=mesh)
    return step(data, 0)


def train_flash(monkeypatch_or_env):
    """K4-K6's plain versions for every training attention."""
    from future_od_tpu_torch.models import layers

    monkeypatch_or_env["FUTURE_OD_TRAIN_FLASH"] = "1"
    layers.TRAIN_FLASH_MIN_KEYS = 1


# ---------------------------------------------------------------------------
# a rank (this file run as a script; no JAX)


def worker(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    train_flash(os.environ)
    from future_od_tpu_torch.data.synthetic import SyntheticClipDataset
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.parallel import distributed
    from future_od_tpu_torch.parallel.mesh import gather_state_dict
    from future_od_tpu_torch.runs import _helper, _loader

    args = _helper.build_base_parser().parse_args([
        "--synthetic", "--debug", "--disable_wandb", "--mesh_model", str(MODEL),
        "--dist_coordinator", f"127.0.0.1:{port}", "--dist_num_processes", str(world),
        "--dist_process_id", str(rank)])
    args.epochs, args.experiment_idf = 1, "tp"
    _helper.start_run(args)
    mesh = _helper._build_mesh(args)
    record = {"mesh": [mesh.shape, mesh.rank, mesh.model_rank]}
    arrays = {}

    state = torch.load(os.path.join(out, "state.pt"), weights_only=True)
    data = first_batch()
    rows = slice(mesh.rank * BATCH // 2, (mesh.rank + 1) * BATCH // 2)
    from future_od_tpu_torch.parallel.mesh import shard_model

    model = shard_model(port_model(state), mesh)
    loss, stats, _, _ = one_step(model, {k: v[rows] for k, v in data.items()}, mesh)
    record["step"] = {"loss": float(loss), "stats": {k: float(v) for k, v in stats.items()}}
    params = dict(model.named_parameters())
    weights = gather_state_dict(model, {n: p.detach() for n, p in params.items()})
    for name, value in weights.items():
        arrays[f"step/{name}"] = value.numpy()
    grads = gather_state_dict(model, {n: p.grad for n, p in params.items() if p.grad is not None})
    for name, value in grads.items():
        arrays[f"step/grad/{name}"] = value.numpy()

    # a Trainer epoch as the run scripts build it, on loaders of the data place's rows
    train = _loader._make_loader(args, SyntheticClipDataset(
        num_samples=TRAIN_CLIPS, image_size=IMAGE_SIZE, max_objects=3, seed=1),
        batch_size=BATCH, shuffle=True, num_workers=1)
    val = _loader._make_loader(args, SyntheticClipDataset(
        num_samples=VAL_CLIPS, image_size=IMAGE_SIZE, max_objects=3, seed=2),
        batch_size=BATCH, shuffle=False, drop_last=False, num_workers=1)
    record["shard"] = list(train.shard)
    config = {"checkpoint_path": os.path.join(out, "ckpt"),
              "visualization_path": os.path.join(out, "vis")}
    trainer = _helper.get_trainer(args, config, SpatioTemporalDETRArgs(**TINY),
                                  lambda e: 1.0, port_model(state), train, {"val0": val})
    trainer.train(1)
    record["train_steps"] = trainer.step
    record["ap_modes"] = sorted(trainer._ap_by_mode)
    full = gather_state_dict(trainer._model)
    for name, value in full.items():
        arrays[f"trainer/{name}"] = value.numpy()
    # a fresh Trainer through get_trainer resumes the checkpoint, cut again
    fresh = _helper.get_trainer(args, config, SpatioTemporalDETRArgs(**TINY),
                                lambda e: 1.0, port_model(seed=5), train, {"val0": val})
    record["resumed_equal"] = fresh.step == trainer.step and all(
        torch.equal(a, b) for a, b in zip(fresh._model.state_dict().values(),
                                          trainer._model.state_dict().values())) and all(
        torch.equal(ma[k], mb[k]) for ma, mb in zip(fresh._optimizer.state.values(),
                                                     trainer._optimizer.state.values())
        for k in ("exp_avg", "exp_avg_sq"))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    distributed.destroy()


# ---------------------------------------------------------------------------
# the parent (pytest)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' records, arrays and logs, and the inputs."""
    out = str(tmp_path_factory.mktemp("tp_ranks"))
    model = port_model()
    torch.save(model.state_dict(), os.path.join(out, "state.pt"))
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "FUTURE_OD_TRAIN_FLASH")}
    env["PYTHONPATH"] = REPO
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), str(RANKS),
                               str(port), out], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
             for r in range(RANKS)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
    records = []
    for r in range(RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            records.append((json.load(f), dict(np.load(os.path.join(out, f"rank{r}.npz")))))
    return dict(out=out, ranks=records, logs=logs, state=model.state_dict())


def test_four_ranks_form_a_data_by_model_mesh(ranks):
    """`--mesh_model 2` over four ranks: a (2, 2) mesh, rank r at data place
    r // 2 and model place r % 2, printed by rank 0 as the JAX run prints
    it; each rank's loader takes its data place's rows."""
    assert "device mesh: data=2 model=2 (4 ranks)" in ranks["logs"][0]
    for r, (record, _) in enumerate(ranks["ranks"]):
        assert record["mesh"] == [{"data": 2, "model": MODEL}, r // MODEL, r % MODEL]
        assert record["shard"] == [r // MODEL, 2]


def test_data_and_tensor_parallel_step_equals_one_process_step(ranks, monkeypatch):
    """The (2, 2) step against the port's one process on the global batch:
    the loss, every stat and every gradient (gathered over each model
    group); the parameters after the step alike on all four ranks. They are
    not held to the one process's: AdamW's first step, g / (|g| + eps),
    maps a rounding of a gradient near eps to up to lr either way."""
    train_flash(os.environ)
    monkeypatch.setenv("FUTURE_OD_TRAIN_FLASH", "1")
    from future_od_tpu_torch.models import layers

    monkeypatch.setattr(layers, "TRAIN_FLASH_MIN_KEYS", 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = port_model(ranks["state"])
        loss, stats, _, _ = one_step(model, first_batch())
    finally:
        torch.set_num_threads(threads)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    largest = max(np.abs(g).max() for g in grads.values())
    (r0, a0) = ranks["ranks"][0]
    for record, arrays in ranks["ranks"]:
        assert record["step"] == r0["step"]
        np.testing.assert_allclose(record["step"]["loss"], float(loss), rtol=LOSS_RTOL)
        for key, value in stats.items():
            np.testing.assert_allclose(record["step"]["stats"][key], float(value),
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=key)
        for name, _ in model.named_parameters():
            np.testing.assert_array_equal(arrays[f"step/{name}"], a0[f"step/{name}"])
        for name, g in grads.items():
            np.testing.assert_allclose(arrays[f"step/grad/{name}"], g, rtol=0,
                                       atol=GRAD_GAP * largest, err_msg=name)


def test_mesh_model_trainer_checkpoint_loads_in_one_process(ranks, tmp_path):
    """The `--mesh_model 2` Trainer's epoch (2 steps, the eval, the AP) and
    its checkpoint, written by rank 0 with the full tensors: a fresh
    `--mesh_model 2` Trainer on each rank resumes it bit for bit (its shares
    cut again), and a one-process Trainer loads it, every parameter equal
    to the ranks' gathered ones, AdamW's moments the full parameters'
    shape."""
    from future_od_tpu_torch.data import loader
    from future_od_tpu_torch.data.synthetic import CATEGORY_DICT
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.train.trainer import Trainer

    for record, arrays in ranks["ranks"]:
        assert record["train_steps"] == TRAIN_CLIPS // BATCH
        assert record["ap_modes"] == ["train", "val0"]
        assert record["resumed_equal"]  # each rank's share of the weights and moments
    assert sorted(os.listdir(os.path.join(ranks["out"], "ckpt"))) == ["tp", "tp_final"]
    one = Trainer(model=port_model(seed=3), detr_args=SpatioTemporalDETRArgs(**TINY),
                  train_loader=None, val_loaders={"val0": loader.Loader([0], batch_size=1)},
                  checkpoint_path=os.path.join(ranks["out"], "ckpt"),
                  visualization_path=str(tmp_path), save_name="tp",
                  category_dict=CATEGORY_DICT, device="cpu")
    one.load_checkpoint()
    assert one.step == TRAIN_CLIPS // BATCH
    for name, p in one._model.named_parameters():
        for _, arrays in ranks["ranks"]:
            np.testing.assert_array_equal(p.detach().numpy(), arrays[f"trainer/{name}"],
                                          err_msg=name)
    names = {id(p): n for n, p in one._model.named_parameters()}
    for p, moments in one._optimizer.state.items():
        assert moments["exp_avg"].shape == p.shape, names[id(p)]


# ---------------------------------------------------------------------------
# the sharding rules against JAX's


def jax_shardings(args_kw, image_size):
    """{JAX leaf path: its PartitionSpec} of the JAX Trainer's
    param_shardings on a (1, 2) mesh, and the JAX variables' shapes."""
    import jax

    from future_od_tpu.data.loader import ARRAY_KEYS
    from future_od_tpu.data.synthetic import SyntheticClipDataset
    from future_od_tpu.models.build import build_flagship
    from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu.parallel.mesh import make_mesh, param_shardings

    model = build_flagship(SpatioTemporalDETRArgs(**args_kw))
    sample = SyntheticClipDataset(num_samples=1, image_size=image_size)[0]
    example = {k: np.asarray(v)[None] for k, v in sample.items() if k in ARRAY_KEYS}
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.key(0)}, example,
                                               deterministic=True))
    specs = param_shardings(shapes["params"], make_mesh(1, MODEL))
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    return {jax.tree_util.keystr(path): tuple(s.spec) for path, s in flat}, shapes


def port_from_jax_specs(args_kw, image_size, mesh):
    """The port's sharding of each parameter as the JAX specs give it,
    through the bridge: each leaf filled with its index, so a port
    parameter's values name the JAX leaves it is made of."""
    import jax

    from future_od_tpu_torch.parallel.mesh import Replicated, Sharded
    from future_od_tpu_torch.utils.jax_weights import state_arrays

    specs, shapes = jax_shardings(args_kw, image_size)
    paths, index = [], {}

    def fill(path, leaf):
        index[jax.tree_util.keystr(path)] = len(paths)
        paths.append(jax.tree_util.keystr(path))
        return np.broadcast_to(np.float32(len(paths) - 1), leaf.shape)

    tree = {"params": jax.tree_util.tree_map_with_path(fill, shapes["params"]),
            "frozen": jax.tree.map(lambda x: np.zeros(x.shape, np.float32), shapes["frozen"])}
    want = {}
    for name, value in state_arrays(tree).items():
        value = np.asarray(value)
        parts = 3 if name.endswith(("in_proj_weight", "in_proj_bias")) else 1
        leaves = [paths[int(v)] for v in value.reshape(parts, -1)[:, 0]]
        spec = {specs.get(p, ()) for p in leaves}
        assert len(spec) == 1, (name, leaves)
        spec = spec.pop()
        if "model" not in spec:
            want[name] = Replicated(mesh)
        else:  # the flax kernel (in, out) is the torch weight (out, in)
            want[name] = Sharded(mesh, 0 if spec in (("model",), (None, "model")) else 1, parts)
    return want


@pytest.mark.parametrize("config", ["tiny", "flagship"])
def test_param_shardings_equal_jax(config):
    """Every parameter of the port's model at a model axis of 2 takes the
    JAX Trainer's sharding of the leaves it is made of (the packed q/k/v
    projection: its three leaves', each cut alike), at the tiny flagship
    and at the flagship's config."""
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.parallel.mesh import Sharded, make_mesh, param_shardings

    kw, size = (TINY, IMAGE_SIZE) if config == "tiny" else (FLAGSHIP, (448, 800))
    mesh = make_mesh(1, MODEL, devices=["cpu", "cpu"])
    want = port_from_jax_specs(kw, size, mesh)
    model = build_flagship(SpatioTemporalDETRArgs(**kw), device="meta")
    got = param_shardings(model, mesh)
    assert got == {name: want[name] for name in got}
    assert sum(isinstance(s, Sharded) for s in got.values()) > (40 if config == "tiny" else 300)


def test_port_replicates_a_block_whose_heads_do_not_split():
    """Where JAX's rules cut a block the port runs replicated: 3 heads of
    16 over a model axis of 2. The JAX rules test divisibility leaf by leaf,
    so they cut every attention projection (48 columns split 24 + 24, half
    a head on each device, which GSPMD handles); the port never cuts a head
    (`splits_over`), so every attention's parameters are replicated, while
    the FFNs (64 hidden units) and the IMU MLP are cut as JAX cuts them.
    Only the attentions' column- and row-parallel leaves differ."""
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.parallel.mesh import Replicated, make_mesh, param_shardings

    kw = {**TINY, "hidden_dim": 48, "nheads": 3, "enc_nheads": 3}
    mesh = make_mesh(1, MODEL, devices=["cpu", "cpu"])
    want = port_from_jax_specs(kw, IMAGE_SIZE, mesh)
    got = param_shardings(build_flagship(SpatioTemporalDETRArgs(**kw), device="meta"), mesh)
    attention = ("self_attn.attn.", "self_attend.", "image_attend.", "egodeep_attend.query",
                 "egodeep_attend.key", "egodeep_attend.value", "egodeep_attend.fun.")
    differ = {n for n in got if got[n] != want[n]}
    assert differ and all(any(a in n for a in attention) for n in differ)
    assert all(isinstance(got[n], Replicated) for n in differ)
    assert all(got[n] == want[n] for n in got if ".mlp." in n or "feedforward" in n
               or "imu_layers" in n)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", nargs=4, metavar=("RANK", "WORLD", "PORT", "DIR"),
                        required=True)
    rank, world, port, out = parser.parse_args().worker
    worker(int(rank), int(world), int(port), out)
