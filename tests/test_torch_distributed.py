"""The port's data parallelism over torch.distributed ranks on the CPU: two
gloo ranks against the JAX package's one program over a 2-device data mesh
of conftest's virtual CPU devices.

The ranks are this file run as a script (`python tests/test_torch_distributed.py
--worker RANK WORLD PORT DIR`), which imports no JAX: the parent writes the
weights and the batch to DIR/inputs.npz, starts both ranks once, and reads
what each wrote back. In one start the ranks (1) join through
`maybe_initialize_distributed` (--dist_* flags, gloo) and sum one tensor;
(2) take one train step of a tiny flagship (D=32, 4 heads, 1+1 layers,
64x128, batch 4 over 2 ranks, dropout 0) at accumulation 1 and 2, each rank
on its two rows, attention through the train flash kernels' plain
versions; (3) draw their step's dropout; (4) train a `Trainer(mesh=...)`
epoch on sharded synthetic loaders (8 train clips at batch 4: 2 steps; 5
validation clips at batch 4: one batch of 4 and a ragged one of 1, which
leaves rank 1 without rows), with its checkpoint and PNGs, then resume a
fresh Trainer from the checkpoint; (5) stop a Trainer on both ranks by a
signal's flag set on one; (6) form a (1, 2) mesh in the same start and take
(2)'s step with the tiny flagship cut over the model axis (tensor
parallelism: 2 of its 4 heads and half its FFN a rank, on all 4 rows), at
accumulation 1 and 2 and at dropout 0.1 (K4-K6's plain versions hashing the
global heads), each rank writing the full parameters and gradients gathered
over the model group.

The JAX side: the JAX Trainer on `make_mesh(2, 1)`, its epoch on the same
loaders and weights, whose first step is (2) at accumulation 1 (the batch
of (2) is the train loader's first of epoch 1), and the jitted step of a
JAX Trainer at accumulation 2. About 70 s alone (the JAX compiles: train
at accumulation 1 and 2, eval at 4 and 1 rows; the ranks run meanwhile).
The (1, 2) steps are held against the same JAX steps and against the port's
one-process step (`one_process_steps`).
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
IMAGE_SIZE = (64, 128)
BATCH, RANKS = 4, 2
ACCUMS = (1, 2)
TRAIN_CLIPS, VAL_CLIPS = 8, 5
# The two ranks against the JAX program on the global batch, f32 on both
# sides: the loss and the loss-derived stats at test_torch_train.py's
# bound (LOSS_RTOL: the port's one-process step against JAX's), the other
# stats exactly as their counts allow, and each parameter after the step
# within 2 lr of JAX's (AdamW's first step moves an element by about lr,
# of either sign where its gradient is near 0), as test_torch_train.py
# holds the one-process step.
LOSS_RTOL = 1e-4
STAT_ATOL = 1e-5
# The two ranks against the port's one process on the same global batch:
# the same arithmetic on half the rows a call. Measured: the loss 1.1e-7
# relative (each stat within that), a parameter 5.5e-3 lr (AdamW's first
# step, g / (|g| + eps), amplifies a rounding of a gradient near eps); each
# tolerance is 10x that.
SAME_LOSS_RTOL = 1.1e-6
SAME_PARAM_ATOL_LR = 5.5e-2
# The (1, 2) tensor-parallel step against the port's one process: the
# same products on half the heads and hidden units a rank, the partial
# products summed over the ranks. Measured, over the three steps: the loss
# 1.2e-7 relative, each clipped gradient within 3.3e-7 of the largest
# gradient element, a parameter 7.9e-3 lr; each tolerance is 10x that.
TP_GRAD_GAP = 3.3e-6
TP_PARAM_ATOL_LR = 7.9e-2
TP_DROPOUT = 0.1
# the (1, 2) steps: (key, accumulation, dropout); the dropout step runs
# with the packed projections (FUTURE_OD_PACKED_PROJ=1), each rank packing
# its own shares
TP_STEPS = (("tp1", 1, 0.0), ("tp2", 2, 0.0), ("tp_dropout_packed", 1, TP_DROPOUT))
# the epoch's meters against the JAX Trainer's (test_torch_trainer.py's
# DRIFT_METER_RTOL) and the AP dicts (AP_ATOL)
DRIFT_METER_RTOL = 2.4e-3
AP_ATOL = 1e-6


def port_model(state=None, seed=0, dropout=0.0):
    """The tiny flagship on the CPU, from `state` (a state dict) or random."""
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs

    model = build_flagship(SpatioTemporalDETRArgs(**{**TINY, "dropout": dropout}), device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    if state is not None:
        model.load_state_dict(state)
    return model


def loaders(loader_module, dataset_class, shard=None):
    """(train, {"val0": val}) over the synthetic clips; `shard` is the
    port's (rank, world)."""
    kw = {} if shard is None else {"shard": shard}
    train = loader_module.Loader(
        dataset_class(num_samples=TRAIN_CLIPS, image_size=IMAGE_SIZE, max_objects=3, seed=1),
        batch_size=BATCH, shuffle=True, num_workers=2, **kw)
    val = loader_module.Loader(
        dataset_class(num_samples=VAL_CLIPS, image_size=IMAGE_SIZE, max_objects=3, seed=2),
        batch_size=BATCH, shuffle=False, seed=loader_module.VAL_SEED, drop_last=False,
        num_workers=2, **kw)
    return train, {"val0": val}


def port_trainer(model, path, mesh=None, shard=None):
    from future_od_tpu_torch.data import loader
    from future_od_tpu_torch.data.synthetic import CATEGORY_DICT, SyntheticClipDataset
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.train.trainer import Trainer

    train, val = loaders(loader, SyntheticClipDataset, shard)
    return Trainer(
        model=model, detr_args=SpatioTemporalDETRArgs(**TINY), train_loader=train,
        val_loaders=val, checkpoint_path=os.path.join(path, "ckpt"),
        visualization_path=os.path.join(path, "vis"), save_name="run",
        category_dict=CATEGORY_DICT, print_interval=100, visualization_epochs={1},
        mesh=mesh, device="cpu")


def recorded_losses(trainer):
    """Wrap the trainer's train step so each call's loss is kept."""
    losses, step = [], trainer._train_step

    def wrapper(*args):
        out = step(*args)
        losses.append(float(out[0]))
        return out
    wrapper.steps = step.steps
    trainer._train_step = wrapper
    return losses


def trainer_state(trainer):
    return {
        "net": {k: v.clone() for k, v in trainer._model.state_dict().items()},
        "optimizer": trainer._optimizer.state_dict(),
        "epoch": trainer._epoch, "step": trainer.step,
        "stats": {k: m.state_dict() for k, m in trainer._stats.items()},
    }


def equal_states(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(equal_states(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(equal_states(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b or (a != a and b != b)


# ---------------------------------------------------------------------------
# a rank (this file run as a script; no JAX)


def worker(rank: int, world: int, port: int, out: str) -> None:
    os.environ["FUTURE_OD_TRAIN_FLASH"] = "1"
    torch.set_num_threads(1)
    import torch.distributed as dist

    from future_od_tpu_torch.models import layers
    from future_od_tpu_torch.parallel import distributed
    from future_od_tpu_torch.parallel.mesh import make_mesh
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.train.optimizer import build_optimizer
    from future_od_tpu_torch.train.step import make_train_step, seeded

    layers.TRAIN_FLASH_MIN_KEYS = 1  # every train attention through K4-K6's plain versions
    flags = argparse.Namespace(dist_coordinator=f"127.0.0.1:{port}", dist_num_processes=world,
                               dist_process_id=rank)
    assert distributed.maybe_initialize_distributed(flags, device_type="cpu")
    total = torch.tensor([rank + 1.0])
    dist.all_reduce(total)
    mesh = make_mesh()
    record = {"all_reduce": total.item(), "mesh": [mesh.shape, mesh.rank],
              "backend": dist.get_backend()}
    arrays = {}

    inputs = np.load(os.path.join(out, "inputs.npz"))
    state = {k[4:]: torch.from_numpy(inputs[k]) for k in inputs.files if k.startswith("net/")}
    data = {k[5:]: inputs[k] for k in inputs.files if k.startswith("data/")}
    rows = slice(rank * BATCH // world, (rank + 1) * BATCH // world)
    args = SpatioTemporalDETRArgs(**TINY)
    for K in ACCUMS:
        model = port_model(state)
        optimizer = build_optimizer(model, args.lr, args.lr_backbone, args.weight_decay,
                                    args.max_norm)
        step = make_train_step(model, args.criterion_config(), optimizer, device="cpu",
                               accum_steps=K, mesh=mesh)
        loss, stats, od_map, output = step({k: v[rows] for k, v in data.items()}, 0)
        record[f"accum{K}"] = {"loss": float(loss), "stats": {k: float(v) for k, v in stats.items()},
                               "output_rows": int(output["boxes"].shape[0])}
        for name, p in model.named_parameters():
            arrays[f"accum{K}/{name}"] = p.detach().numpy()

    with seeded(0, 0, torch.device("cpu"), rank=mesh.rank):
        record["dropout_seed"] = layers.draw_dropout_seed(0.1)
        arrays["dropout_mask"] = torch.nn.functional.dropout(torch.ones(64), 0.5).numpy()

    trainer = port_trainer(port_model(state), out, mesh=mesh, shard=(rank, world))
    trainer.load_checkpoint()  # none yet: warns and goes on, on every rank
    record["train_losses"] = recorded_losses(trainer)
    trainer.train(1)
    record["meters"] = {k: m.history for k, m in trainer._stats.items()}
    record["ap"] = {mode: {k: v.tolist() for k, v in ap.items()}
                    for mode, ap in trainer._ap_by_mode.items()}
    fresh = port_trainer(port_model(seed=5), out, mesh=mesh, shard=(rank, world))
    fresh.load_checkpoint()
    record["resumed_equal"] = equal_states(trainer_state(fresh), trainer_state(trainer))
    for name, p in trainer._model.named_parameters():
        arrays[f"trainer/{name}"] = p.detach().numpy()

    # a signal on rank 1 alone stops both ranks before their next step
    from future_od_tpu_torch.utils.signals import EXIT

    stopped = port_trainer(port_model(state), out, mesh=mesh, shard=(rank, world))
    stopped._save_checkpoints = False
    if rank == 1:
        EXIT.set()
    stopped.train(1)
    EXIT.clear()
    record["steps_after_a_signal"] = stopped.step

    tensor_parallel_steps(state, data, record, arrays)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    distributed.destroy()


def tensor_parallel_steps(state, data, record, arrays):
    """(6): the steps on a (1, 2) mesh, every rank on the whole batch."""
    from future_od_tpu_torch.parallel import distributed
    from future_od_tpu_torch.parallel.mesh import gather_state_dict, make_mesh, shard_model

    mesh = make_mesh(1, 2)
    record["tp_mesh"] = [mesh.shape, mesh.rank, mesh.model_rank]
    for key, K, dropout in TP_STEPS:
        model = shard_model(port_model(state, dropout=dropout), mesh)
        distributed.MODEL_REDUCES.update(count=0, bytes=0)
        if key == "tp_dropout_packed":  # the packed projections, cut per projection
            os.environ["FUTURE_OD_PACKED_PROJ"] = "1"
        loss, stats, _, output = one_step(model, data, K, mesh, dropout)
        os.environ.pop("FUTURE_OD_PACKED_PROJ", None)
        record[key] = {"loss": float(loss), "stats": {k: float(v) for k, v in stats.items()},
                       "output_rows": int(output["boxes"].shape[0]),
                       "model_reduces": dict(distributed.MODEL_REDUCES),
                       "local_heads": model._model.separate_encoder.transformer.layers[0]
                       .self_attn.attn.in_proj_weight.shape[0] // 3}
        params = dict(model.named_parameters())
        weights = gather_state_dict(model, {n: p.detach() for n, p in params.items()})
        for name, value in weights.items():
            arrays[f"{key}/{name}"] = value.numpy()
        grads = gather_state_dict(model, {n: p.grad for n, p in params.items() if p.grad is not None})
        for name, value in grads.items():
            arrays[f"{key}/grad/{name}"] = value.numpy()


def one_step(model, data, K, mesh=None, dropout=0.0):
    """One train step of `model` on `data` (seed 0) at accumulation K."""
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.train.optimizer import build_optimizer
    from future_od_tpu_torch.train.step import make_train_step

    args = SpatioTemporalDETRArgs(**{**TINY, "dropout": dropout})
    optimizer = build_optimizer(model, args.lr, args.lr_backbone, args.weight_decay,
                                args.max_norm)
    step = make_train_step(model, args.criterion_config(), optimizer, device="cpu",
                           accum_steps=K, mesh=mesh)
    return step(data, 0)


# ---------------------------------------------------------------------------
# the parent (pytest)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax():
    import jax
    import jax.numpy as jnp

    from future_od_tpu.data import loader as jax_loader
    from future_od_tpu.data.synthetic import SyntheticClipDataset as JaxDataset
    from future_od_tpu.models.build import build_flagship as jax_build_flagship
    from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs
    from future_od_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from future_od_tpu.train.trainer import Trainer as JaxTrainer
    from future_od_tpu.utils.wandb import WandBConfig as JaxWandBConfig
    return argparse.Namespace(**locals())


def jax_variables(J):
    """The JAX flagship and its variables: `jax.eval_shape` of the init
    filled from numpy seeds (test_torch_variants.py::random_variables)."""
    from test_torch_variants import random_variables

    train, _ = loaders(J.jax_loader, J.JaxDataset)
    jmodel = J.jax_build_flagship(J.JaxArgs(**TINY))
    example = {k: J.jnp.asarray(v) for k, v in next(iter(train)).items()
               if k in J.jax_loader.ARRAY_KEYS}
    shapes = J.jax.eval_shape(lambda: jmodel.init({"params": J.jax.random.key(0)}, example,
                                                  deterministic=True))
    return jmodel, random_variables(shapes)


def jax_trainer(J, jmodel, variables, path, accum_steps=1):
    """A JAX Trainer on a 2-device data mesh holding `variables`, on the JAX
    loaders of the same data."""
    from future_od_tpu_torch.data.synthetic import CATEGORY_DICT

    train, val = loaders(J.jax_loader, J.JaxDataset)
    trainer = J.JaxTrainer(
        model=jmodel, detr_args=J.JaxArgs(**TINY), train_loader=train, val_loaders=val,
        checkpoint_path=os.path.join(path, "jax"), visualization_path=os.path.join(path, "jv"),
        save_name="run", category_dict=CATEGORY_DICT, print_interval=100,
        checkpoint_epochs=False, wandb_config=J.JaxWandBConfig(enabled=False),
        variables=J.jax.tree.map(J.jnp.asarray, variables), mesh=J.jax_make_mesh(RANKS, 1),
        accum_steps=accum_steps)
    trainer._grad_audit = lambda data: None
    return trainer


def first_train_batch(loader_module, dataset_class):
    """The train loader's first batch of epoch 1, which the Trainers'
    first step takes."""
    train, _ = loaders(loader_module, dataset_class)
    train.set_epoch(1)
    return {k: np.asarray(v) for k, v in next(iter(train)).items()
            if k in loader_module.ARRAY_KEYS}


def jax_step_result(J, state, loss, stats):
    from future_od_tpu_torch.utils.jax_weights import flagship_state_arrays

    return {"loss": float(loss), "stats": {k: float(v) for k, v in stats.items()},
            "params": flagship_state_arrays(J.jax.tree.map(np.asarray, {
                "params": state.params, "frozen": state.frozen}))}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test (the tier-1 run gives each file one of six
    workers; test_torch_flash_tc_rounding.py's fixture, which imports JAX
    at the top, as this file must not)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' records and arrays, the inputs, and the JAX side's
    step results and Trainer."""
    from future_od_tpu_torch.data import loader
    from future_od_tpu_torch.data.synthetic import SyntheticClipDataset
    from future_od_tpu_torch.utils.jax_weights import load_jax_variables

    J = _jax()
    out = str(tmp_path_factory.mktemp("ranks"))
    jmodel, variables = jax_variables(J)
    model = port_model()
    load_jax_variables(model, variables)
    data = first_train_batch(loader, SyntheticClipDataset)
    np.savez(os.path.join(out, "inputs.npz"),
             **{f"net/{k}": v.numpy() for k, v in model.state_dict().items()},
             **{f"data/{k}": v for k, v in data.items()})
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "FUTURE_OD_TRAIN_FLASH")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), str(RANKS),
                               str(port), out], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
             for r in range(RANKS)]

    # the JAX side meanwhile: the mesh Trainer's epoch, whose first step is
    # the step at accumulation 1 on `data`, then one step at accumulation 2
    # from the same weights and batch through another mesh Trainer's step
    steps = {}
    jtrainer = jax_trainer(J, jmodel, variables, out)
    jax_step = jtrainer._train_step

    def first_step(state, batch, rng):
        new_state, loss, stats, od_map, output = jax_step(state, batch, rng)
        if 1 not in steps:
            assert all(np.array_equal(np.asarray(batch[k]), v) for k, v in data.items())
            steps[1] = jax_step_result(J, new_state, loss, stats)
        return new_state, loss, stats, od_map, output
    jtrainer._train_step = first_step
    jtrainer.train(1)
    accum = jax_trainer(J, jmodel, variables, out, accum_steps=2)
    jdata = {k: J.jnp.asarray(v) for k, v in data.items()}
    state, loss, stats, _, _ = accum._train_step(accum.state, accum._device_batch(jdata),
                                                 accum._rng)
    steps[2] = jax_step_result(J, state, loss, stats)

    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append((json.load(f), dict(np.load(os.path.join(out, f"rank{r}.npz")))))
    return dict(out=out, ranks=ranks, logs=logs, model=model, data=data, steps=steps,
                jtrainer=jtrainer)


def test_two_ranks_join_and_sum(run):
    """The counterpart of tests/test_distributed_multiprocess.py: both ranks
    join through maybe_initialize_distributed (gloo on the CPU, said on
    the log) and one all-reduce sums 1 + 2."""
    for r, ((record, _), log) in enumerate(zip(run["ranks"], run["logs"])):
        assert record["all_reduce"] == 3.0
        assert record["backend"] == "gloo"
        assert record["mesh"] == [{"data": RANKS, "model": 1}, r]
        assert f"rank {r} of {RANKS} on cpu, backend gloo" in log


@pytest.mark.parametrize("K", ACCUMS)
def test_step_matches_the_jax_mesh_step(run, K):
    """One step at accumulation K: both ranks return the global loss and
    stats, equal to the JAX program's on the 2-device mesh, and hold the
    same parameters, each within 2 lr of JAX's after its update."""
    want = run["steps"][K]
    (r0, a0), (r1, a1) = run["ranks"]
    for record in (r0, r1):
        got = record[f"accum{K}"]
        assert got["output_rows"] == BATCH // RANKS
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        assert set(got["stats"]) == set(want["stats"])
        for key, value in want["stats"].items():
            rtol = LOSS_RTOL if key in ("labels", "box_l1", "box_giou") else 0
            np.testing.assert_allclose(got["stats"][key], value, rtol=rtol, atol=STAT_ATOL,
                                       err_msg=key)
    prefix = f"accum{K}/"
    names = [k[len(prefix):] for k in a0 if k.startswith(prefix)]
    assert len(names) > 100
    for name in names:
        assert np.array_equal(a0[prefix + name], a1[prefix + name]), name
        lr = TINY["lr_backbone"] if "backbone" in name else TINY["lr"]
        np.testing.assert_allclose(a0[prefix + name], want["params"][name], rtol=0,
                                   atol=2 * lr, err_msg=name)


@pytest.fixture(scope="module")
def one_process_steps(run):
    """The port's one-process step on the global batch and the same weights,
    attention through the train flash kernels' plain versions as in the
    ranks: {(K, dropout): (loss, stats, {name: parameter}, {name: its
    clipped gradient})}."""
    from future_od_tpu_torch.models import layers

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FUTURE_OD_TRAIN_FLASH", "1")
        mp.setattr(layers, "TRAIN_FLASH_MIN_KEYS", 1)
        # one thread, as the ranks (a module fixture runs before the
        # function-scoped `one_torch_thread`)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        for K, dropout in {(K, dropout) for _, K, dropout in TP_STEPS}:
            model = port_model(run["model"].state_dict(), dropout=dropout)
            loss, stats, _, _ = one_step(model, run["data"], K, dropout=dropout)
            out[K, dropout] = (
                float(loss), {k: float(v) for k, v in stats.items()},
                {n: p.detach().numpy() for n, p in model.named_parameters()},
                {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None})
        torch.set_num_threads(threads)
    return out


def assert_step_equals(got, arrays, prefix, want, param_atol_lr):
    """A rank's step record and parameters against a one-process step."""
    loss, stats, params, _ = want
    np.testing.assert_allclose(got["loss"], loss, rtol=SAME_LOSS_RTOL)
    for key, value in stats.items():
        np.testing.assert_allclose(got["stats"][key], value, rtol=SAME_LOSS_RTOL,
                                   atol=1e-7, err_msg=key)
    for name, value in params.items():
        lr = TINY["lr_backbone"] if "backbone" in name else TINY["lr"]
        np.testing.assert_allclose(arrays[f"{prefix}/{name}"], value, rtol=0,
                                   atol=param_atol_lr * lr, err_msg=name)


@pytest.mark.parametrize("K", ACCUMS)
def test_step_equals_one_process_step(run, one_process_steps, K):
    """The two ranks against the port's one-process step on the global
    batch and the same weights: the loss, every stat and every parameter."""
    record, arrays = run["ranks"][0]
    assert_step_equals(record[f"accum{K}"], arrays, f"accum{K}", one_process_steps[K, 0.0],
                       SAME_PARAM_ATOL_LR)


def test_tensor_parallel_mesh_cuts_the_model(run):
    """The (1, 2) mesh of the two ranks: one data place, each rank its
    model place, 2 of the 4 heads a rank; the blocks' sums over the model
    group ran, each rank the same number and bytes."""
    for r, (record, _) in enumerate(run["ranks"]):
        assert record["tp_mesh"] == [{"data": 1, "model": RANKS}, 0, r]
        assert record["tp1"]["local_heads"] == TINY["hidden_dim"] // RANKS
        assert record["tp1"]["model_reduces"]["count"] > 0
        assert record["tp1"]["model_reduces"] == run["ranks"][0][0]["tp1"]["model_reduces"]


@pytest.mark.parametrize("K", ACCUMS)
def test_tensor_parallel_step_matches_the_jax_mesh_step(run, K):
    """The (1, 2) step at accumulation K against the JAX program's step
    (the same function): the loss and stats at the JAX bounds, the gathered
    parameters within 2 lr of JAX's and equal on both ranks."""
    want = run["steps"][K]
    (r0, a0), (r1, a1) = run["ranks"]
    for record in (r0, r1):
        got = record[f"tp{K}"]
        assert got["output_rows"] == BATCH
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        for key, value in want["stats"].items():
            rtol = LOSS_RTOL if key in ("labels", "box_l1", "box_giou") else 0
            np.testing.assert_allclose(got["stats"][key], value, rtol=rtol, atol=STAT_ATOL,
                                       err_msg=key)
    for name, value in want["params"].items():
        if name.endswith(("running_mean", "running_var")) or f"tp{K}/{name}" not in a0:
            continue
        assert np.array_equal(a0[f"tp{K}/{name}"], a1[f"tp{K}/{name}"]), name
        lr = TINY["lr_backbone"] if "backbone" in name else TINY["lr"]
        np.testing.assert_allclose(a0[f"tp{K}/{name}"], value, rtol=0, atol=2 * lr, err_msg=name)


@pytest.mark.parametrize("key,K,dropout", TP_STEPS)
def test_tensor_parallel_step_equals_one_process_step(run, one_process_steps, key, K, dropout):
    """The (1, 2) step against the port's one-process step of the same
    seed: the loss and stats, every gradient and every parameter, at
    TP_*'s bounds. At dropout 0.1 the ranks draw the one process's masks:
    the in-kernel mask at the global heads (K4-K6's plain versions) and
    the sharded dropouts' slices of the full masks; that step runs the
    packed projections (one matmul over the projections an input feeds,
    FUTURE_OD_PACKED_PROJ=1), each rank packing its own shares, against
    the one process's unpacked step."""
    want = one_process_steps[K, dropout]
    grads = want[3]
    largest = max(np.abs(g).max() for g in grads.values())
    for record, arrays in run["ranks"]:
        assert_step_equals(record[key], arrays, key, want, TP_PARAM_ATOL_LR)
        for name, g in grads.items():
            np.testing.assert_allclose(arrays[f"{key}/grad/{name}"], g, rtol=0,
                                       atol=TP_GRAD_GAP * largest, err_msg=name)


def test_ranks_draw_different_dropout(run):
    """The rank is folded into the step's seed: the two ranks' in-kernel
    dropout seeds (K4-K6's mask) and torch dropout masks differ."""
    (r0, a0), (r1, a1) = run["ranks"]
    assert r0["dropout_seed"] != r1["dropout_seed"]
    assert not np.array_equal(a0["dropout_mask"], a1["dropout_mask"])


def test_trainer_epoch_matches_the_jax_mesh_trainer(run):
    """The 2-rank Trainer epoch (2 train steps, the eval with its ragged
    batch) against the JAX Trainer on the 2-device mesh: the same meters on
    both ranks within the drift of test_torch_trainer.py, and AP dicts
    equal to JAX's for train and val0."""
    jtrainer = run["jtrainer"]
    (r0, _), (r1, _) = run["ranks"]
    assert r0["meters"] == r1["meters"] and r0["ap"] == r1["ap"]
    assert len(r0["train_losses"]) == TRAIN_CLIPS // BATCH
    assert set(r0["meters"]) == set(jtrainer._stats)
    for key, meter in jtrainer._stats.items():
        np.testing.assert_allclose(r0["meters"][key], meter.history, rtol=DRIFT_METER_RTOL,
                                   atol=1e-12, err_msg=key)
    assert set(r0["ap"]) == set(jtrainer._ap_by_mode) == {"train", "val0"}
    for mode, ap in jtrainer._ap_by_mode.items():
        for key, value in ap.items():
            got = np.asarray(r0["ap"][mode][key], dtype=np.float64)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(value))
            np.testing.assert_allclose(got, value, rtol=0, atol=AP_ATOL, err_msg=f"{mode} {key}")


def test_a_signal_on_one_rank_stops_both(run):
    """SIGTERM's flag set on rank 1 only: both ranks leave the epoch before
    its first step (a rank that went on would wait forever in the next
    collective)."""
    assert [record["steps_after_a_signal"] for record, _ in run["ranks"]] == [0, 0]


def test_trainer_checkpoint_and_resume(run):
    """Rank 0 wrote the one checkpoint (and its _final), which a fresh
    Trainer on each rank resumes bit for bit."""
    (r0, _), (r1, _) = run["ranks"]
    assert sorted(os.listdir(os.path.join(run["out"], "ckpt"))) == ["run", "run_final"]
    blob = torch.load(os.path.join(run["out"], "ckpt", "run"), weights_only=True)
    assert blob["step"] == TRAIN_CLIPS // BATCH and blob["epoch"] == 1
    assert r0["resumed_equal"] and r1["resumed_equal"]


def test_pngs_equal_a_one_process_run(run, tmp_path):
    """The PNGs rank 0 drew from the batches gathered from both ranks are
    the files a one-process Trainer draws."""
    trainer = port_trainer(port_model(run["model"].state_dict()), str(tmp_path))
    trainer.train(1)
    ours = os.path.join(run["out"], "vis")
    theirs = str(tmp_path / "vis")
    names = sorted(os.listdir(theirs))
    assert names == sorted(os.listdir(ours)) and len(names) == 8  # train + val0, 4 each
    for name in names:
        with open(os.path.join(ours, name), "rb") as a, open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", nargs=4, metavar=("RANK", "WORLD", "PORT", "DIR"),
                        required=True)
    rank, world, port, out = parser.parse_args().worker
    worker(int(rank), int(world), int(port), out)
