"""Multi-process bootstrap of the port (counterpart of
``sml_tpu/parallel/distributed.py``).

One process per device.  ``initialize`` joins this process to the others with
``torch.distributed.init_process_group`` when a coordinator is configured:
``coordinator_address`` ("host:port" of rank 0), ``num_processes`` and
``process_id`` (the JAX package's flags), or else torchrun's ``MASTER_ADDR`` /
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  Without one it does nothing
and the process runs alone, as before.

Each rank's device is ``cuda:(LOCAL_RANK or process_id) % device_count``, or
the CPU when the caller asks for it.  The backend is gloo on the CPU; on the
card NCCL when each rank has a card of its own (the ranks on this host,
``LOCAL_WORLD_SIZE`` or all of them, no more than its cards), else gloo over
the CUDA tensors (NCCL refuses two ranks on one card).  Rank 0 prints it.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist

_INITIALIZED = False


def _launch(config) -> Tuple[str, int, int]:
    """(coordinator "host:port", number of processes, this process's id) from
    the config, else torchrun's variables; ("", 0, -1) when there is none."""
    addr = getattr(config, "coordinator_address", "") if config is not None else ""
    nproc = int(getattr(config, "num_processes", 0) or 0) if config is not None else 0
    pid = int(getattr(config, "process_id", -1)) if config is not None else -1
    if not addr and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    nproc = nproc or int(os.environ.get("WORLD_SIZE", "0"))
    if pid < 0:
        pid = int(os.environ.get("RANK", "-1"))
    return addr, nproc, pid


def choose_backend(device: torch.device, ranks_here: int) -> Tuple[str, str]:
    """(backend, why) for ranks on ``device``'s kind, ``ranks_here`` of them on
    this host."""
    if device.type != "cuda":
        return "gloo", "CPU tensors"
    cards = torch.cuda.device_count()
    if ranks_here <= cards:
        return "nccl", f"{ranks_here} rank(s) on this host, {cards} card(s): one each"
    return "gloo", (f"{ranks_here} ranks on this host share {cards} card(s); NCCL takes "
                    "one rank per card, gloo runs the collectives on the CUDA tensors")


def initialize(config=None, device: str | torch.device = "cuda") -> torch.device:
    """Join the process group if a coordinator is configured; returns this
    rank's device (``device`` itself when the process runs alone)."""
    global _INITIALIZED
    device = torch.device(device)
    addr, nproc, pid = _launch(config)
    if not (addr and nproc >= 1 and pid >= 0) or dist.is_initialized():
        return device
    if pid >= nproc:
        raise ValueError(f"process_id {pid} outside the {nproc} processes")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available; "
                               "pass --device cpu to run the ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK", pid))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend, why = choose_backend(device, int(os.environ.get("LOCAL_WORLD_SIZE", nproc)))
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=nproc,
                            rank=pid)
    _INITIALIZED = True
    if pid == 0:
        print(f"distributed: {nproc} rank(s), backend {backend} ({why})", flush=True)
    return device


def shutdown() -> None:
    """Leave the process group that ``initialize`` joined."""
    global _INITIALIZED
    if _INITIALIZED and dist.is_initialized():
        from sml_tpu_torch.parallel.mesh import reset_grid

        dist.destroy_process_group()
        reset_grid()
    _INITIALIZED = False


def process_info() -> Tuple[int, int]:
    """(rank, number of ranks): (0, 1) when the process runs alone."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """Whether this process logs, prints and writes files (rank 0)."""
    return process_info()[0] == 0
