"""Joining a process group across hosts (counterpart of
fei_tpu/parallel/distributed.py).

The JAX package joins ``jax.distributed`` so one controller sees every
host's devices. The port's ranks are processes, so a multi-host serving
mesh is one ``torch.distributed`` process group: every host starts its
processes, rank 0 serves and the others follow its dispatches
(parallel/serving.py). ``initialize()`` reads the environment, with the
reference's three variables:

  FEI_TPU_COORDINATOR   host:port of process 0
  FEI_TPU_NUM_PROCESSES world size
  FEI_TPU_PROCESS_ID    this process's rank

With none of them set it is a no-op (a single host starts its own ranks
from ``InferenceEngine.from_config``). A rank that cannot reach its group
raises; nothing carries on as a single rank.

The backend follows where the ranks live (``choose_backend``): NCCL when
every rank has a card of its own, gloo when ranks share a device (the CPU,
or two ranks on one card, whose tensors and kernels stay on the card).
``initialize`` counts the ranks on this host from ``LOCAL_WORLD_SIZE``
when it is set, else all of them when the coordinator is this host
(localhost), else one.
"""

from __future__ import annotations

import os

import torch

from fei_tpu_torch.utils.logging import get_logger

log = get_logger("parallel.distributed")

_initialized = False


def is_initialized() -> bool:
    return _initialized


def choose_backend(device_type: str, ranks_on_host: int) -> tuple[str, bool]:
    """``(backend, shared)``: NCCL when each of the host's ranks can own a
    card, else gloo with every rank on one shared device (``shared``)."""
    if device_type != "cuda":
        return "gloo", True
    if torch.cuda.device_count() >= ranks_on_host:
        return "nccl", False
    return "gloo", True


_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1", "[::1]")


def ranks_on_host(coordinator_address: str, num_processes: int) -> int:
    """How many of the group's ranks run on this host: ``LOCAL_WORLD_SIZE``
    when set, every rank when the coordinator is this host, else one."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local:
        return int(local)
    host = coordinator_address.split("://")[-1].rsplit(":", 1)[0]
    return int(num_processes) if host in _LOCAL_HOSTS else 1


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device_type: str | None = None,
) -> bool:
    """Join the multi-host group. Returns True if distributed mode is active
    after the call. Idempotent. ``device_type`` ("cuda" or "cpu") picks the
    backend (default: cuda when a card is visible) with ``ranks_on_host``:
    NCCL with card ``process_id % device_count`` when each of the host's
    ranks has a card, else gloo with every rank on card 0."""
    global _initialized
    if _initialized:
        return True
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("FEI_TPU_COORDINATOR")
    env_np = os.environ.get("FEI_TPU_NUM_PROCESSES")
    env_pid = os.environ.get("FEI_TPU_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)
    if coordinator_address is None and num_processes is None:
        log.debug("no coordinator configured; staying single-host")
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "multi-host init needs FEI_TPU_COORDINATOR, FEI_TPU_NUM_PROCESSES and "
            "FEI_TPU_PROCESS_ID (or the matching arguments) together")
    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    backend, shared = choose_backend(device_type, ranks_on_host(coordinator_address,
                                                                num_processes))
    if device_type == "cuda":
        torch.cuda.set_device(0 if shared else process_id % torch.cuda.device_count())
    from fei_tpu_torch.parallel.mesh import COLLECTIVE_TIMEOUT

    addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=addr, world_size=int(num_processes),
                            rank=int(process_id), timeout=COLLECTIVE_TIMEOUT)
    _initialized = True
    log.info("distributed: process %d/%d over %s (%s, %s)", process_id, num_processes,
             backend, "sharing one device" if shared else "one card each", addr)
    return True


def process_info() -> dict:
    """This process's view of the cluster (works single-host too)."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": local,
        "global_devices": dist.get_world_size() if up else local,
        "distributed": _initialized,
        "backend": dist.get_backend() if up else None,
    }
