"""Device mesh and sharding rules (port of future_od_tpu/parallel/mesh.py).

A `Mesh` is a (data, model) grid of torch devices, the counterpart of
`jax.sharding.Mesh(grid, ("data", "model"))`. Two kinds exist:

- under an initialized process group (`parallel/distributed.py`), the grid
  is the ranks, row by row (the model index varies fastest, as JAX's
  `reshape(num_data, num_model)`): each process knows its place on both
  axes (`Mesh.rank` on the data axis, `Mesh.model_rank` on the model axis)
  and the process groups of its data axis (the ranks of its model index)
  and of its model axis (the ranks of its data place); `train/step.py`
  and `train/trainer.py` reduce over them explicitly;
- without one, a grid of this process's devices: the server and the
  streaming session (`serve/`) spread their batch rows over it, one model
  replica a device. A grid given explicitly may list one device twice, as
  the JAX tests list virtual CPU devices.

Data parallelism (the reference's only strategy) shards the batch's leading
dim over "data" in contiguous blocks (`batch_sharding`) and replicates the
parameters. Tensor parallelism (a model axis above 1, the JAX Trainer's
`param_shardings`) cuts the transformer's projections over "model" by the
JAX package's rules, Megatron-style (`shard_model`): column-parallel
projections (and their biases) hold H/M of a block's heads or a 1/M of its
hidden units, row-parallel outputs (`fc2`, `out_proj`) the matching 1/M of
their inputs, and their partial products are summed over the model group
(`distributed.reduce_from_model`); everything else is replicated. A block
whose heads or widths do not split over M (or whose attention is captured)
runs replicated, and `param_shardings` says so: the port never cuts a head.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from future_od_tpu_torch.parallel import distributed

AXES = ("data", "model")
# why the server and the streaming session refuse a model axis above 1
SERVING_MODEL_AXIS = ("serving takes a model axis of 1, as the JAX server does "
                      "(future_od_tpu/serve/server.py asserts it): tensor parallelism "
                      "cuts the training steps only")


class Mesh:
    """A (data, model) grid of torch devices. Under a process group: `rank`
    is this process's place on the data axis, `model_rank` its place on the
    model axis, `data_group` / `model_group` the `distributed.Group`s of the
    ranks it shares a model index / a data place with. Without one, `rank`
    is None and there are no groups."""

    def __init__(self, devices, rank: Optional[int] = None, model_rank: int = 0,
                 data_group: Optional[distributed.Group] = None,
                 model_group: Optional[distributed.Group] = None):
        grid = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        self.devices = grid
        self.rank = rank
        self.model_rank = model_rank
        self.data_group = data_group
        self.model_group = model_group

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def distributed(self) -> bool:
        """Whether the grid is the ranks of a process group."""
        return self.rank is not None

    @property
    def model_axis(self) -> Optional[distributed.ModelAxis]:
        """This rank's place on the model axis, for the tensor-parallel
        modules; None at a model axis of 1 or without a process group."""
        if not self.distributed or self.shape["model"] == 1:
            return None
        return distributed.ModelAxis(self.shape["model"], self.model_rank, self.model_group)

    @property
    def main(self) -> bool:
        """Data place 0, model place 0 (or no process group): the rank that
        prints and writes."""
        return not self.distributed or (self.rank == 0 and self.model_rank == 0)

    def data_devices(self) -> List[torch.device]:
        """The device of each place on the data axis (model index 0)."""
        return list(self.devices[:, 0])

    @property
    def local_device(self) -> torch.device:
        """This rank's device (the first device without a process group)."""
        return self.devices[self.rank or 0, self.model_rank]

    def __repr__(self) -> str:
        where = f", rank {self.rank}/{self.model_rank}" if self.distributed else ""
        return f"Mesh({self.shape}{where}: {[str(d) for d in self.devices.ravel()]})"


def local_devices(device_type: str = "cuda") -> List[torch.device]:
    """This process's devices: every visible card, or the CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh. Under an initialized process group its devices
    are the ranks' (gathered from every rank), rank r at (r // num_model,
    r % num_model), with the groups of both axes; else `devices` (default:
    every visible card). Asserts when asked for more devices than there
    are, as the JAX function does."""
    rank = None
    if devices is None and distributed.is_initialized():
        here = str(distributed.local_device())
        devices = [torch.device(d) for d in distributed.all_gather_objects(here)]
        rank = distributed.rank()
    elif devices is None:
        devices = local_devices()
    devices = list(devices)
    if num_data is None:
        num_data = len(devices) // num_model
    assert num_data * num_model <= len(devices), (
        f"need {num_data}x{num_model} devices, have {len(devices)}"
    )
    grid = np.empty((num_data, num_model), dtype=object)
    for i, d in enumerate(devices[: num_data * num_model]):
        grid[i // num_model, i % num_model] = d
    if rank is None:
        return Mesh(grid)
    if rank >= grid.size:
        raise ValueError(f"rank {rank} lies outside the {num_data}x{num_model} mesh")
    data_groups, model_groups = mesh_groups(num_data, num_model)
    data, model = divmod(rank, num_model)
    return Mesh(grid, data, model, data_groups[model], model_groups[data])


def mesh_groups(num_data: int, num_model: int):
    """(the data axis's group of each model index, the model axis's group of
    each data place) of a (num_data, num_model) grid of the ranks, made
    once a run on every rank in the same order (torch's new_group is
    collective) and kept until `distributed.destroy`."""
    cache = distributed.run_state().setdefault("mesh_groups", {})
    key = (num_data, num_model)
    if key not in cache:
        sets = ([[d * num_model + m for d in range(num_data)] for m in range(num_model)]
                + [[d * num_model + m for m in range(num_model)] for d in range(num_data)])
        groups = distributed.new_groups(sets)
        cache[key] = (groups[:num_model], groups[num_model:])
    return cache[key]


@dataclass(frozen=True)
class BatchSharding:
    """The leading (batch) dim in contiguous blocks over "data", the rest
    replicated: NamedSharding(mesh, P("data"))."""

    mesh: Mesh

    def blocks(self, rows: int) -> List[slice]:
        """The rows of each place on the data axis; raises ValueError with
        the sizes when they do not split evenly (as jax.device_put does)."""
        n = self.mesh.shape["data"]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split evenly over a data axis "
                             f"of {n}")
        step = rows // n
        return [slice(i * step, (i + 1) * step) for i in range(n)]


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Shard the leading (batch) dim over "data", replicate the rest."""
    return BatchSharding(mesh)


# The JAX package's rules (future_od_tpu/parallel/mesh.py), on the JAX leaf
# paths of the port's parameters (`utils/jax_weights.py::jax_param_paths`):
# param-path substrings -> the kernel's and the bias's PartitionSpec on the
# model axis. Column-parallel layers (sharded output) shard their bias too;
# row-parallel layers ("model" on the input dim) keep the bias replicated.
_COL_PARALLEL = (
    "fc1",  # FFN up-projection
    "query_content", "key_content", "value", "query_pos", "key_pos",
    "query_sine", "q_proj", "k_proj", "v_proj", "key']",
)
_ROW_PARALLEL = ("fc2", "out_proj")


def _spec_for(path: str, ndim: int) -> tuple:
    """The JAX PartitionSpec (as a tuple) of the flax leaf at `path` with
    `ndim` dims: a kernel is (in, out), a bias (out,)."""
    if ndim == 2:
        for token in _ROW_PARALLEL:
            if token in path:
                return ("model", None)
        for token in _COL_PARALLEL:
            if token in path:
                return (None, "model")
    if ndim == 1:
        for token in _COL_PARALLEL:
            if token in path:
                return ("model",)
    return ()


@dataclass(frozen=True)
class Replicated:
    """Every device holds the whole value: NamedSharding(mesh, P())."""

    mesh: Mesh


@dataclass(frozen=True)
class Sharded:
    """A parameter cut over "model" along its torch dim `dim`: a
    column-parallel weight (out, in) or bias along 0 (JAX P(None, "model"),
    P("model")), a row-parallel weight along 1 (P("model", None)). `parts`
    > 1: the dim holds that many JAX leaves end to end (the packed q/k/v
    projection), each cut alike, and a rank's share is its cut of each."""

    mesh: Mesh
    dim: int
    parts: int = 1


Sharding = Union[Replicated, Sharded]


def replicate(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def _jax_sharding(name: str, shape, mesh: Mesh) -> Sharding:
    """The JAX rule's sharding of the port's parameter `name` of `shape`,
    with the JAX function's guard: a leaf whose cut dim does not divide by
    the model axis is replicated."""
    from future_od_tpu_torch.utils.jax_weights import jax_param_paths

    paths = jax_param_paths(name, len(shape))
    specs = {_spec_for(p, len(shape)) for p in paths}
    spec = specs.pop()
    if specs or "model" not in spec:
        return Replicated(mesh)
    # the flax kernel is (in, out), the torch weight (out, in)
    dim = 0 if len(spec) == 1 or spec == (None, "model") else 1
    if (shape[dim] // len(paths)) % mesh.shape["model"]:
        return Replicated(mesh)
    return Sharded(mesh, dim, len(paths))


def is_block(module: torch.nn.Module) -> bool:
    """Whether `module` is a tensor-parallel block: it says whether it
    splits over a model axis (`splits_over`) and runs over one given its
    `model_axis` (models/layers.py)."""
    return hasattr(module, "splits_over") and hasattr(module, "model_axis")


def _block_shardings(model: torch.nn.Module, mesh: Mesh):
    """({parameter name: its sharding}, the blocks that run cut): a block
    runs cut when it splits over the model axis and the JAX rules cut every
    weight it owns (the innermost block holding a parameter owns it); its
    parameters then take the rules' shardings, every other one is
    replicated."""
    M = mesh.shape["model"]
    named = dict(model.named_parameters())
    owners: Dict[str, torch.nn.Module] = {}
    for prefix, module in model.named_modules():  # parents before children
        if is_block(module):
            for name, _ in module.named_parameters(prefix=prefix):
                owners[name] = module
    out = {name: Replicated(mesh) for name in named}
    cut = []
    for block in {id(b): b for b in owners.values()}.values():
        own = [n for n, b in owners.items() if b is block]
        rules = {n: _jax_sharding(n, tuple(named[n].shape), mesh) for n in own}
        if M > 1 and block.splits_over(M) and all(
                isinstance(rules[n], Sharded) for n in own if named[n].dim() == 2):
            out.update(rules)
            cut.append(block)
    return out, cut


def param_shardings(params, mesh: Mesh) -> Dict[str, Sharding]:
    """{parameter name: its sharding} for a module's parameters (or a dict
    of tensors by the port's names): everything replicated at a model axis
    of 1; above 1, the JAX package's spec for every parameter, except the
    parameters of a block that does not split over the model axis
    (`splits_over`: heads or hidden units that do not divide, a captured
    attention), which the port runs replicated. A parameter outside the
    tensor-parallel blocks matches no rule (the trunk, the norms, the
    heads' MLPs) and is replicated. A dict has no blocks to say what splits,
    so it is taken at a model axis of 1 only."""
    if not isinstance(params, dict):
        return _block_shardings(params, mesh)[0]
    if mesh.shape["model"] != 1:
        raise ValueError("param_shardings: above a model axis of 1 the shardings come "
                         "from the model's blocks; pass the module, not a dict")
    return {name: Replicated(mesh) for name in params}


def _concat(chunks, dim: int):
    if len(chunks) == 1:
        return chunks[0]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks, dim)
    return np.concatenate(chunks, dim)


def shard_tensor(value, sharding: Optional[Sharding], index: int):
    """Model rank `index`'s share of a full tensor or numpy array (the
    value itself when replicated or without a sharding)."""
    if not isinstance(sharding, Sharded):
        return value
    M, dim, parts = sharding.mesh.shape["model"], sharding.dim, sharding.parts
    piece = value.shape[dim] // parts
    size = piece // M
    chunks = []
    for j in range(parts):
        cut = [slice(None)] * len(value.shape)
        cut[dim] = slice(j * piece + index * size, j * piece + (index + 1) * size)
        chunks.append(value[tuple(cut)])
    return _concat(chunks, dim)


def gather_tensor(shares: Sequence, sharding: Optional[Sharding]):
    """The full tensor of every model rank's share, in model order (the
    inverse of `shard_tensor`)."""
    if not isinstance(sharding, Sharded):
        return shares[0]
    dim, parts = sharding.dim, sharding.parts
    size = shares[0].shape[dim] // parts
    chunks = []
    for j in range(parts):
        for share in shares:
            cut = [slice(None)] * len(share.shape)
            cut[dim] = slice(j * size, (j + 1) * size)
            chunks.append(share[tuple(cut)])
    return _concat(chunks, dim)


def shard_state_dict(state: Dict[str, object], shardings: Dict[str, Sharding],
                     index: int) -> Dict[str, object]:
    """Model rank `index`'s share of a full state dict (tensors, or numpy
    arrays such as `utils/jax_weights.py::state_arrays` of a JAX tree):
    each sharded parameter cut, the rest (buffers too) as it is."""
    return {k: shard_tensor(v, shardings.get(k), index) for k, v in state.items()}


def _all_gather(t: torch.Tensor, group: distributed.Group) -> List[torch.Tensor]:
    """Every rank of `group`'s `t`, in group order (through the host when a
    CUDA tensor goes over gloo)."""
    import torch.distributed as dist

    src = t.detach()
    src = (src.cpu() if distributed._staged(src, group) else src).contiguous()
    out = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(out, src, group=group.handle)
    return [o.to(t.device) for o in out]


def tensor_parallel(model: torch.nn.Module) -> Optional[Mesh]:
    """The mesh `shard_model` cut the model over, or None."""
    return getattr(model, "_tensor_parallel_mesh", None)


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Cut `model` (whole, as built or loaded) over the mesh's model axis,
    in place: each parameter `param_shardings` shards keeps this rank's
    share (the same Parameter objects, so build the optimizer after or
    before, but step it after), and each block that splits runs its
    tensor-parallel forward over the model group. A no-op at a model axis
    of 1; raises ValueError for a model axis without a process group or a
    model cut already."""
    axis = mesh.model_axis
    if mesh.shape["model"] == 1:
        return model
    if axis is None:
        raise ValueError(f"{mesh}: tensor parallelism runs one process a device; start one "
                         "rank a device (torchrun, or --dist_*) and pass make_mesh(...)")
    if tensor_parallel(model) is not None:
        raise ValueError("the model is cut over a model axis already")
    shardings, blocks = _block_shardings(model, mesh)
    for block in blocks:
        block.model_axis = axis
    with torch.no_grad():
        for name, p in model.named_parameters():
            if isinstance(shardings[name], Sharded):
                p.data = shard_tensor(p.data, shardings[name], axis.index).clone()
    model._tensor_parallel_mesh = mesh
    return model


def sharded_params(model: torch.nn.Module) -> set:
    """The ids of the parameters a `shard_model` cut holds a share of."""
    mesh = tensor_parallel(model)
    if mesh is None:
        return set()
    full = param_shardings(model, mesh)
    return {id(p) for n, p in model.named_parameters() if isinstance(full[n], Sharded)}


def gather_state_dict(model: torch.nn.Module,
                      state: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The model's full state dict (or the full tensors of `state`, tensors
    shaped as the named parameters, such as their gradients), each share
    gathered over the model group (a collective: every rank of the group
    calls it); as it is when the model is not cut."""
    mesh = tensor_parallel(model)
    state = model.state_dict() if state is None else state
    if mesh is None:
        return state
    shardings = param_shardings(model, mesh)
    return {k: gather_tensor(_all_gather(v, mesh.model_group), shardings[k])
            if isinstance(shardings.get(k), Sharded) else v for k, v in state.items()}


def load_full_state_dict(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load a full state dict (a one-process checkpoint's) into a model, cut
    to this rank's share when the model is cut."""
    mesh = tensor_parallel(model)
    if mesh is not None:
        state = shard_state_dict(state, param_shardings(model, mesh), mesh.model_rank)
    model.load_state_dict(state, strict=True)


def _moment_shardings(optimizer, model: torch.nn.Module, mesh: Mesh) -> Dict[int, Sharding]:
    """{the optimizer's parameter index: its sharding}, the indices of
    `optimizer.state_dict()` (the groups' parameters in order)."""
    shardings = param_shardings(model, mesh)
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    return {i: shardings[names[id(p)]] for i, p in enumerate(params)}


_MOMENTS = ("exp_avg", "exp_avg_sq")


def gather_optimizer_state(optimizer, model: torch.nn.Module) -> dict:
    """The optimizer's state dict with AdamW's moments of every cut
    parameter gathered over the model group (a collective), as a
    one-process optimizer's; its own state dict when the model is not
    cut."""
    state = optimizer.state_dict()
    mesh = tensor_parallel(model)
    if mesh is None:
        return state
    shardings = _moment_shardings(optimizer, model, mesh)
    # state_dict() hands out the optimizer's own per-parameter dicts
    state["state"] = {i: dict(moments) for i, moments in state["state"].items()}
    for i, moments in state["state"].items():
        if isinstance(shardings[i], Sharded):
            for key in _MOMENTS:
                moments[key] = gather_tensor(_all_gather(moments[key], mesh.model_group),
                                             shardings[i])
    return state


def load_full_optimizer_state(optimizer, model: torch.nn.Module, state: dict) -> None:
    """Load a one-process optimizer state dict, each cut parameter's
    moments cut to this rank's share."""
    mesh = tensor_parallel(model)
    if mesh is not None:
        shardings = _moment_shardings(optimizer, model, mesh)
        state = copy.copy(state)
        state["state"] = {
            i: {k: shard_tensor(v, shardings[int(i)], mesh.model_rank) if k in _MOMENTS else v
                for k, v in moments.items()}
            for i, moments in state["state"].items()}
    optimizer.load_state_dict(state)


def split_rows(rows: int, parts: int) -> List[slice]:
    """`rows` in `parts` contiguous blocks, the first `rows % parts` one row
    longer (a ragged batch; a block may be empty)."""
    bounds = np.cumsum([0] + [rows // parts + (i < rows % parts) for i in range(parts)])
    return [slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def module_replicas(model: torch.nn.Module, devices: Sequence[torch.device]
                    ) -> Dict[torch.device, torch.nn.Module]:
    """{device: a replica of `model` on it}, one a distinct device: the model
    itself on its own device, a deep copy elsewhere."""
    home = next(model.parameters()).device
    replicas: Dict[torch.device, torch.nn.Module] = {}
    for d in devices:
        if d not in replicas:
            replicas[d] = model if d == home else copy.deepcopy(model).to(d)
    return replicas


def gather_rows(outs: List[Dict[str, torch.Tensor]], device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """Output dicts of the devices' row blocks as one dict, the rows in
    block order, on `device` (one block: its dict as it is)."""
    if len(outs) == 1:
        return outs[0]
    return {k: torch.cat([o[k].to(device, non_blocking=True) for o in outs]) for k in outs[0]}
