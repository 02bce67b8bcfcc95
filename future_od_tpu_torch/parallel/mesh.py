"""Device mesh and sharding rules (port of future_od_tpu/parallel/mesh.py).

A `Mesh` is a (data, model) grid of torch devices, the counterpart of
`jax.sharding.Mesh(grid, ("data", "model"))`. Two kinds exist:

- under an initialized process group (`parallel/distributed.py`), the data
  axis is the ranks: each process knows its own place (`Mesh.rank`) and
  computes its rows; `train/step.py` and `train/trainer.py` reduce across
  the ranks explicitly;
- without one, a grid of this process's devices: the server and the
  streaming session (`serve/`) spread their batch rows over it, one model
  replica a device. A grid given explicitly may list one device twice, as
  the JAX tests list virtual CPU devices.

Data parallelism (the reference's only strategy) shards the batch's leading
dim over "data" in contiguous blocks (`batch_sharding`) and replicates the
parameters (`param_shardings`, `replicate`). Tensor parallelism (a model
axis above 1) is not ported yet: ROADMAP.md Queue 1 item 4b.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from future_od_tpu_torch.parallel import distributed

AXES = ("data", "model")
TENSOR_PARALLEL_ITEM = ("tensor parallelism (a model axis above 1) is not ported yet "
                        "(ROADMAP.md Queue 1 item 4b)")


class Mesh:
    """A (data, model) grid of torch devices. `rank` is this process's place
    on the data axis when the data axis is the ranks of a process group,
    else None."""

    def __init__(self, devices, rank: Optional[int] = None):
        grid = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        self.devices = grid
        self.rank = rank

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def distributed(self) -> bool:
        """Whether the data axis is the ranks of a process group."""
        return self.rank is not None

    def data_devices(self) -> List[torch.device]:
        """The device of each place on the data axis (model index 0)."""
        return list(self.devices[:, 0])

    @property
    def local_device(self) -> torch.device:
        """This rank's device (the first device without a process group)."""
        return self.devices[self.rank or 0, 0]

    def __repr__(self) -> str:
        where = f", rank {self.rank}" if self.distributed else ""
        return f"Mesh({self.shape}{where}: {[str(d) for d in self.devices.ravel()]})"


def local_devices(device_type: str = "cuda") -> List[torch.device]:
    """This process's devices: every visible card, or the CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh. Under an initialized process group its devices
    are the ranks' (gathered from every rank), and this process's place is
    its rank; else `devices` (default: every visible card). Asserts when
    asked for more devices than there are, as the JAX function does."""
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
    if rank is not None:
        if rank >= grid.size:
            raise ValueError(f"rank {rank} lies outside the {num_data}x{num_model} mesh")
        rank //= num_model
    return Mesh(grid, rank)


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


@dataclass(frozen=True)
class Replicated:
    """Every device holds the whole value: NamedSharding(mesh, P())."""

    mesh: Mesh


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Shard the leading (batch) dim over "data", replicate the rest."""
    return BatchSharding(mesh)


def replicate(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def param_shardings(params, mesh: Mesh) -> Dict[str, Replicated]:
    """{parameter name: its sharding} for a module's parameters (or a dict
    of them): everything replicated at a model axis of 1. A model axis above
    1 raises NotImplementedError (item 4b)."""
    if mesh.shape["model"] != 1:
        raise NotImplementedError(TENSOR_PARALLEL_ITEM)
    names = params.keys() if isinstance(params, dict) else (n for n, _ in params.named_parameters())
    return {name: replicate(mesh) for name in names}


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
