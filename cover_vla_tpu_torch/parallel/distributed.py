"""Multi-process initialisation and cross-process helpers over
torch.distributed.

The reference's backend is torch.distributed over NCCL: a process group
from torchrun's environment, `all_reduce` for metric aggregation, a
barrier. Here:

  * `init_multihost()` makes the default process group from arguments or
    the environment: NCCL on the rank's CUDA device (`LOCAL_RANK`), gloo
    only when the caller asks for the CPU. Nothing falls back from one to
    the other.
  * `aggregate_metrics` is the mean of scalar metrics over processes (one
    all-gather of an fp32 vector in sorted key order).
  * `barrier()` waits for every process.

The environment is read under the JAX package's names (COORDINATOR_ADDRESS,
NUM_PROCESSES, PROCESS_ID) or torchrun's (MASTER_ADDR / MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK). A coordinator address is ``host:port`` (a
TCP rendezvous) or a ``file://`` URL (a FileStore: no port at all).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist


def _half_configured(env, num_processes, process_id) -> bool:
    """World-size or rank information present without an address."""
    if num_processes or process_id or env.get("NUM_PROCESSES") \
            or env.get("PROCESS_ID"):
        return True
    return (int(env.get("WORLD_SIZE", "1")) > 1
            or int(env.get("RANK", "0")) > 0)


def resolve_multihost_env(coordinator_address: Optional[str] = None,
                          num_processes: Optional[int] = None,
                          process_id: Optional[int] = None,
                          env: Optional[Dict[str, str]] = None
                          ) -> Optional[Dict]:
    """The process group's address, world size and rank from explicit
    arguments or the environment. Returns None for a single-process run
    (no address configured anywhere). Raises ValueError on a
    half-configured environment: world-size or rank information without an
    address would otherwise run as a single process of the wrong world
    size."""
    env = os.environ if env is None else env
    address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if address is None and env.get("MASTER_ADDR"):
        if not env.get("MASTER_PORT"):
            raise ValueError("MASTER_ADDR is set but MASTER_PORT is not")
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if address is None:
        if _half_configured(env, num_processes, process_id):
            raise ValueError(
                "NUM_PROCESSES/PROCESS_ID (or WORLD_SIZE/RANK) configured "
                "but no COORDINATOR_ADDRESS (or MASTER_ADDR) — refusing a "
                "silent single-process fallback in a multi-process launch")
        return None
    world = env.get("NUM_PROCESSES", env.get("WORLD_SIZE"))
    rank_ = env.get("PROCESS_ID", env.get("RANK"))
    return {
        "coordinator_address": address,
        "num_processes": (num_processes if num_processes is not None
                          else int(world) if world is not None else 1),
        "process_id": (process_id if process_id is not None
                       else int(rank_) if rank_ is not None else 0),
    }


def local_device(device=None) -> torch.device:
    """`device` when given, else this rank's CUDA device (`LOCAL_RANK`,
    0 without it). Raises without a GPU and without an explicit device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device=None) -> bool:
    """Make the default process group from arguments or the environment:
    NCCL on `local_device(device)` when that is a CUDA device (set as the
    current device first), gloo when it is the CPU. Returns False, and
    does nothing, for a single process."""
    kwargs = resolve_multihost_env(coordinator_address, num_processes,
                                   process_id)
    if kwargs is None:
        return False
    dev = local_device(device)
    address = kwargs["coordinator_address"]
    init = {"init_method": address if "://" in address
            else f"tcp://{address}",
            "world_size": kwargs["num_processes"],
            "rank": kwargs["process_id"]}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **init)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", **init)
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    return True


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _comm_device() -> torch.device:
    """Where the default group's collectives take their tensors: the
    current CUDA device under NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "barrier") -> None:
    """Wait until every process reaches the barrier `name`."""
    if world_size() > 1:
        dist.barrier()


def aggregate_metrics(metrics: Dict[str, float]) -> Dict[str, float]:
    """Mean of scalar metrics across processes (the reference's
    all_reduce of its metric deques)."""
    if world_size() == 1:
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    local = torch.tensor([float(metrics[k]) for k in keys],
                         dtype=torch.float32, device=_comm_device())
    gathered = torch.empty(world_size() * len(keys), dtype=torch.float32,
                           device=local.device)
    dist.all_gather_into_tensor(gathered, local)
    mean = gathered.view(world_size(), len(keys)).mean(dim=0).cpu()
    return {k: float(mean[i]) for i, k in enumerate(keys)}
