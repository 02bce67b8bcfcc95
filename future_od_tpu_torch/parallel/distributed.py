"""Multi-process runtime (port of future_od_tpu/parallel/distributed.py).

The JAX package runs one process a host and wires the hosts into one JAX
runtime, whose one GSPMD program then spans every device. The port runs one
process a card, torch's idiom: `maybe_initialize_distributed` joins the
processes into one `torch.distributed` process group, each process takes its
own card, and the train step reduces explicitly (`train/step.py`).

`distributed_config` is the JAX package's pure decision function, copied
bit for bit (the port imports nothing of the JAX package): the flags
--dist_coordinator / --dist_num_processes / --dist_process_id first, then
COORDINATOR_ADDRESS + NUM_PROCESSES + PROCESS_ID, then SLURM.
`--dist_coordinator auto` (JAX's argument-less `initialize()`) reads
torchrun's variables through `init_method="env://"`, as does a run that
torchrun started without any of those flags.

A rank's card: its local rank (LOCAL_RANK under torchrun, SLURM_LOCALID
under SLURM, else the process id) modulo the host's card count. The backend is NCCL when every
rank of a host has a card of its own; gloo on the CPU, or when ranks share a
card (NCCL refuses two ranks on one device). The choice is printed. Host
objects (AP accumulators, the batches a PNG draws, the exit flag) travel
over a gloo group beside an NCCL one (`host_group`): gloo's gathers take no
CUDA tensors.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DistConfig:
    coordinator_address: str
    num_processes: int
    process_id: int


def distributed_config(
    args=None, env: Optional[Mapping[str, str]] = None
) -> Optional[DistConfig]:
    """How to initialize the process group, or None for a single process
    (and for `--dist_coordinator auto`, which `maybe_initialize_distributed`
    handles). Sources, in precedence order: the flags, COORDINATOR_ADDRESS +
    NUM_PROCESSES (+ PROCESS_ID), SLURM (SLURM_NTASKS > 1, the coordinator
    the first host of SLURM_STEP_NODELIST at port 8476). A partial flag or
    env set raises ValueError, as does more than one process without an
    explicit id (every process defaulting to rank 0 would split the job)."""
    env = os.environ if env is None else env

    coord = getattr(args, "dist_coordinator", None)
    nproc = getattr(args, "dist_num_processes", None)
    pid = getattr(args, "dist_process_id", None)
    if coord == "auto":
        return None
    if coord or nproc or pid is not None:
        if not (coord and nproc):
            raise ValueError(
                "partial distributed flags: --dist_coordinator and "
                "--dist_num_processes must be given together"
                + (" (got only --dist_process_id)" if pid is not None and not coord else "")
            )
        if int(nproc) > 1 and pid is None:
            raise ValueError(
                "--dist_num_processes > 1 requires an explicit "
                "--dist_process_id (defaulting every host to rank 0 would "
                "split-brain the job)"
            )
        return DistConfig(coord, int(nproc), int(pid or 0))

    if env.get("COORDINATOR_ADDRESS") or env.get("NUM_PROCESSES"):
        if not (env.get("COORDINATOR_ADDRESS") and env.get("NUM_PROCESSES")):
            raise ValueError(
                "partial distributed env: COORDINATOR_ADDRESS and "
                "NUM_PROCESSES must be set together"
            )
        if int(env["NUM_PROCESSES"]) > 1 and "PROCESS_ID" not in env:
            raise ValueError(
                "NUM_PROCESSES > 1 requires an explicit PROCESS_ID env var"
            )
        return DistConfig(
            env["COORDINATOR_ADDRESS"],
            int(env["NUM_PROCESSES"]),
            int(env.get("PROCESS_ID", 0)),
        )

    if int(env.get("SLURM_NTASKS", "1")) > 1:
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
        head = nodelist.split(",")[0].split("[")[0]
        if "[" in nodelist:  # compressed range: take the first index
            first = nodelist.split("[")[1].split("-")[0].split(",")[0].rstrip("]")
            head = head + first
        return DistConfig(
            f"{head}:8476",
            int(env["SLURM_NTASKS"]),
            int(env.get("SLURM_PROCID", 0)),
        )

    return None


def launched_by_torchrun(env: Optional[Mapping[str, str]] = None) -> bool:
    env = os.environ if env is None else env
    return all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def local_card(rank: int, env: Optional[Mapping[str, str]] = None,
               cards: Optional[int] = None) -> int:
    """The card of the process of rank `rank` on its host: its local rank
    (LOCAL_RANK under torchrun, SLURM_LOCALID under SLURM, else its rank)
    modulo the host's cards, so ranks beyond the cards share them."""
    env = os.environ if env is None else env
    local = next((int(env[k]) for k in ("LOCAL_RANK", "SLURM_LOCALID") if k in env), rank)
    cards = torch.cuda.device_count() if cards is None else cards
    return local % max(cards, 1)


def choose_backend(world_size: int, device_type: str,
                   env: Optional[Mapping[str, str]] = None,
                   cards: Optional[int] = None) -> str:
    """"nccl" when every rank of a host has a card of its own, else "gloo"
    (the CPU, or ranks sharing a card). The ranks a host runs:
    LOCAL_WORLD_SIZE (torchrun), SLURM_NTASKS_PER_NODE, else all of them."""
    env = os.environ if env is None else env
    if device_type != "cuda":
        return "gloo"
    cards = torch.cuda.device_count() if cards is None else cards
    local = int(env.get("LOCAL_WORLD_SIZE") or env.get("SLURM_NTASKS_PER_NODE")
                or world_size)
    return "nccl" if local <= cards else "gloo"


# this process's run: its device and the group for host objects (gloo
# beside NCCL; None when the default group is gloo already)
_RUN: Dict[str, Any] = {}


def maybe_initialize_distributed(args=None, device_type: Optional[str] = None) -> bool:
    """Join this process to the run's process group; a no-op for one
    process. Returns True when a process group is (already) up. On CUDA the
    process takes its card (`torch.cuda.set_device`) before anything else
    touches one, so "cuda" means this rank's card from then on.
    device_type: "cuda" or "cpu" (default: "cuda" when a card is visible)."""
    if dist.is_available() and dist.is_initialized():
        return True
    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    if getattr(args, "dist_coordinator", None) == "auto" or (
            distributed_config(args) is None and launched_by_torchrun()):
        init_method, world, rank = ("env://", int(os.environ["WORLD_SIZE"]),
                                    int(os.environ["RANK"]))
    else:
        cfg = distributed_config(args)
        if cfg is None:
            return False
        init_method, world, rank = (f"tcp://{cfg.coordinator_address}", cfg.num_processes,
                                    cfg.process_id)
    backend = choose_backend(world, device_type)
    card = None
    if device_type == "cuda":
        card = local_card(rank)
        torch.cuda.set_device(card)
    kwargs = {"device_id": torch.device("cuda", card)} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **kwargs)
    _RUN.update(host_group=dist.new_group(backend="gloo") if backend == "nccl" else None,
                device=torch.device("cuda", card) if card is not None else torch.device("cpu"))
    print(f"torch.distributed: rank {rank} of {world} on {_RUN['device']}, backend {backend} "
          f"({init_method.split('://')[0]}://)", flush=True)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or a single process (the reference gates downloads, prints,
    W&B and checkpoint writes on it)."""
    return rank() == 0


def host_group():
    """The group host objects travel over: gloo (None: the default group,
    when it is gloo already)."""
    return _RUN.get("host_group")


def local_device() -> torch.device:
    """This rank's device (the CPU when no process group was joined here)."""
    return _RUN.get("device", torch.device("cpu"))


def all_gather_objects(obj) -> list:
    """Every rank's `obj` (picklable host values), in rank order."""
    out = [None] * world_size()
    dist.all_gather_object(out, obj, group=host_group())
    return out


def barrier() -> None:
    if is_initialized():
        dist.barrier(group=host_group())


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is True on any."""
    if not is_initialized():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return bool(t.item())


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()
    _RUN.clear()


def mesh_axes(total_devices: int, local_devices: int, num_model: int = 1):
    """Size the ("data", "model") mesh for a (possibly multi-host) run.

    Tensor parallelism must stay within a host: num_model must divide the
    LOCAL device count; the data axis takes everything else."""
    assert num_model >= 1 and total_devices % num_model == 0
    assert local_devices % num_model == 0, (
        f"model axis {num_model} must divide local device count {local_devices} "
        "(tensor parallelism must not cross hosts)"
    )
    return total_devices // num_model, num_model


# elements a bucket of `all_reduce_sum_` (64 MB of f32): the flat copy the
# all-reduce works on is at most this large
GRAD_BUCKET = 1 << 24


def all_reduce_sum_(tensors) -> None:
    """Sum each tensor over the ranks, in place: flattened into buckets of
    up to GRAD_BUCKET elements (one dtype and device a bucket), one
    all-reduce a bucket. CUDA tensors go over NCCL, or, when the ranks
    share a card (gloo), through a copy on the host."""
    if not is_initialized():
        return
    groups: Dict[Any, list] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        bucket, size = [], 0
        for t in group + [None]:
            if t is not None and (not bucket or size + t.numel() <= GRAD_BUCKET):
                bucket.append(t)
                size += t.numel()
                continue
            flat = torch.cat([b.reshape(-1) for b in bucket])
            if flat.is_cuda and dist.get_backend() == "gloo":  # ranks sharing a card
                flat = flat.cpu()
            dist.all_reduce(flat)
            for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(part.view_as(b))
            bucket, size = ([t], t.numel()) if t is not None else ([], 0)


def gather_objects_to_main(obj) -> Optional[list]:
    """Every rank's `obj` (picklable host values) on rank 0, in rank order;
    None on the other ranks."""
    out = [None] * world_size() if rank() == 0 else None
    dist.gather_object(obj, out, dst=0, group=host_group())
    return out
