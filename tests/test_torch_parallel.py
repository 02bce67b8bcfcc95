"""The port's `parallel/` against the JAX package's, on the CPU: the launch
decision (`distributed_config` over the cases of
tests/test_sharding.py::TestDistributedConfig, field for field and error
for error), `mesh_axes`, `make_mesh` and the batch sharding's blocks; the
port's own pieces (the card and backend a rank takes, ragged row blocks,
the replicas of a model, the bucketed all-reduce in a one-process group).
About 3 s alone.
"""
import argparse
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from future_od_tpu.parallel import distributed as jax_distributed
from future_od_tpu.parallel import mesh as jax_mesh

from future_od_tpu_torch.parallel import distributed, mesh
from future_od_tpu_torch.train.step import data_parallel


def flags(coord=None, nproc=None, pid=None):
    return argparse.Namespace(dist_coordinator=coord, dist_num_processes=nproc,
                              dist_process_id=pid)


# (args, env) cases of TestDistributedConfig
CASES = {
    "single process": (None, {}),
    "single slurm task": (None, {"SLURM_NTASKS": "1"}),
    "explicit env": (None, {"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "4",
                            "PROCESS_ID": "2"}),
    "slurm": (None, {"SLURM_NTASKS": "2", "SLURM_PROCID": "1",
                     "SLURM_STEP_NODELIST": "tpu-host[03-04]"}),
    "slurm plain list": (None, {"SLURM_NTASKS": "3", "SLURM_PROCID": "2",
                                "SLURM_NODELIST": "a7,b8,c9"}),
    "flags take precedence": (flags("head:9", 8, 3), {"COORDINATOR_ADDRESS": "x:1",
                                                      "NUM_PROCESSES": "2"}),
    "one process by flags": (flags("head:9", 1), {}),
    "auto": (flags("auto"), {}),
    "partial: coordinator alone": (flags("head:9"), {}),
    "partial: no process id": (flags("head:9", 4), {}),
    "partial: process id alone": (flags(pid=0), {}),
    "partial env": (None, {"COORDINATOR_ADDRESS": "x:1"}),
    "env without process id": (None, {"COORDINATOR_ADDRESS": "x:1", "NUM_PROCESSES": "4"}),
}


def outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except (ValueError, AssertionError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("case", sorted(CASES))
def test_distributed_config_equals_jax(case):
    args, env = CASES[case]
    ours = outcome(distributed.distributed_config, args, env=env)
    theirs = outcome(jax_distributed.distributed_config, args, env=env)
    if ours[0] == "ok" and ours[1] is not None:
        ours = ("ok", vars(ours[1]))
        theirs = (theirs[0], vars(theirs[1]))
    assert ours == theirs


@pytest.mark.parametrize("sizes", [(16, 4, 4), (8, 8, 1), (8, 8, 2), (16, 4, 8), (6, 6, 4)])
def test_mesh_axes_equals_jax(sizes):
    """The data axis takes what the model axis leaves; the model axis stays
    within a host (asserts otherwise)."""
    assert outcome(distributed.mesh_axes, *sizes) == outcome(jax_distributed.mesh_axes, *sizes)


@pytest.mark.parametrize("shape", [(8, 1), (2, 1), (4, 2), (1, 8), (None, 1), (None, 4),
                                   (9, 1), (4, 4)])
def test_make_mesh_equals_jax(shape):
    """Over 8 devices (the port: a grid listing the CPU 8 times; JAX:
    conftest's 8 virtual CPU devices), the same axis sizes, and the same
    assertion when asked for more than there are."""
    ours = outcome(mesh.make_mesh, *shape, devices=["cpu"] * jax.device_count())
    theirs = outcome(jax_mesh.make_mesh, *shape)
    if ours[0] == "ok":
        ours, theirs = ("ok", ours[1].shape), ("ok", dict(theirs[1].shape))
    assert ours == theirs


@pytest.mark.parametrize("rows", [8, 6, 5])
def test_batch_sharding_blocks_equal_jax(rows):
    """batch_sharding's blocks are the rows jax.device_put gives each device
    of a 2-device data mesh, and both refuse a batch that does not split."""
    ours = outcome(mesh.batch_sharding(mesh.make_mesh(2, 1, devices=["cpu", "cpu"])).blocks, rows)
    jmesh = jax_mesh.make_mesh(2, 1)

    def shards(n):
        x = jax.device_put(jnp.arange(n), jax_mesh.batch_sharding(jmesh))
        return [np.asarray(s.data).tolist() for s in sorted(
            x.addressable_shards, key=lambda s: s.index[0].start)]
    theirs = outcome(shards, rows)
    if ours[0] == "ok":
        ours = ("ok", [list(range(rows))[b] for b in ours[1]])
    assert ours[0] == theirs[0]
    if ours[0] == "ok":
        assert ours == theirs


def test_param_shardings_replicate_and_wait_for_tensor_parallelism():
    model = torch.nn.Linear(3, 4)
    one = mesh.make_mesh(2, 1, devices=["cpu", "cpu"])
    assert mesh.param_shardings(model, one) == {"weight": mesh.replicate(one),
                                                "bias": mesh.replicate(one)}
    with pytest.raises(NotImplementedError, match="Queue 1 item 4b"):
        mesh.param_shardings(model, mesh.make_mesh(1, 2, devices=["cpu", "cpu"]))


def test_split_rows_of_a_ragged_batch():
    assert mesh.split_rows(5, 2) == [slice(0, 3), slice(3, 5)]
    assert mesh.split_rows(1, 3) == [slice(0, 1), slice(1, 1), slice(1, 1)]
    assert mesh.split_rows(4, 2) == mesh.batch_sharding(
        mesh.make_mesh(2, 1, devices=["cpu", "cpu"])).blocks(4)


def test_module_replicas_one_a_device():
    model = torch.nn.Linear(2, 2)
    replicas = mesh.module_replicas(model, [torch.device("cpu")] * 2)
    assert list(replicas.values()) == [model]


def test_card_and_backend_of_a_rank():
    """A rank's card: LOCAL_RANK, SLURM_LOCALID, else its id, modulo the
    cards; NCCL only when every rank of a host has a card of its own."""
    assert distributed.local_card(5, env={"LOCAL_RANK": "1"}, cards=2) == 1
    assert distributed.local_card(5, env={"SLURM_LOCALID": "0"}, cards=2) == 0
    assert distributed.local_card(5, env={}, cards=2) == 1
    assert distributed.local_card(1, env={"LOCAL_RANK": "1"}, cards=1) == 0  # a shared card
    assert distributed.choose_backend(2, "cpu", env={}, cards=0) == "gloo"
    assert distributed.choose_backend(2, "cuda", env={"LOCAL_WORLD_SIZE": "2"}, cards=2) == "nccl"
    assert distributed.choose_backend(2, "cuda", env={"LOCAL_WORLD_SIZE": "2"}, cards=1) == "gloo"
    assert distributed.choose_backend(8, "cuda", env={"SLURM_NTASKS_PER_NODE": "4"},
                                      cards=4) == "nccl"
    assert distributed.choose_backend(1, "cuda", env={}, cards=1) == "nccl"
    assert distributed.launched_by_torchrun({"RANK": "0", "WORLD_SIZE": "1",
                                             "MASTER_ADDR": "h", "MASTER_PORT": "1"})
    assert not distributed.launched_by_torchrun({"RANK": "0"})


def test_one_process_group(monkeypatch):
    """A group of one process joined through the env variables: a mesh of
    its one rank, which the steps take as data-parallel; the bucketed
    all-reduce (buckets of 5 elements here) writes every tensor back in
    place, mixed sizes and dtypes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    monkeypatch.setattr(distributed, "GRAD_BUCKET", 5)
    assert distributed.maybe_initialize_distributed(device_type="cpu")
    try:
        one = mesh.make_mesh()
        assert one.shape == {"data": 1, "model": 1} and one.rank == 0
        assert data_parallel(one) is one and data_parallel(mesh.make_mesh(
            1, 1, devices=["cpu"])) is None
        tensors = [torch.arange(n, dtype=dt) for n, dt in
                   ((3, torch.float32), (7, torch.float32), (2, torch.float64), (1, torch.float32))]
        want = [t.clone() for t in tensors]
        distributed.all_reduce_sum_(tensors)
        assert all(torch.equal(t, w) for t, w in zip(tensors, want))
        assert distributed.any_rank(True) and not distributed.any_rank(False)
        assert distributed.all_gather_objects({"a": 1}) == [{"a": 1}]
    finally:
        distributed.destroy()
    assert not distributed.is_initialized()
