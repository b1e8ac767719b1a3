"""Multi-process launch and rendezvous: one data-parallel worker per
process.

Counterpart of ``oktopk_tpu/launch.py:91-165``. The discovery rules are
the same, in the same order, and the first that matches wins:

1. explicit ``OKTOPK_NUM_PROCS`` / ``OKTOPK_PROC_ID`` /
   ``OKTOPK_COORDINATOR`` (one process per host, as the JAX rule assumes,
   unless a local rank below is given);
2. SLURM: ``SLURM_PROCID`` / ``SLURM_NTASKS`` / ``SLURM_STEP_NODELIST``
   (the coordinator is the first host of the nodelist, parsed here);
3. OpenMPI: ``OMPI_COMM_WORLD_RANK`` / ``OMPI_COMM_WORLD_SIZE`` (the
   coordinator must then come from ``OKTOPK_COORDINATOR``);
4. PyTorch's own launcher, ``torchrun``: ``RANK`` / ``WORLD_SIZE`` /
   ``MASTER_ADDR`` / ``MASTER_PORT``;
5. a single process.

The local rank, which picks this process's card, comes from
``LOCAL_RANK``, ``SLURM_LOCALID`` or ``OMPI_COMM_WORLD_LOCAL_RANK``, in
that order, else 0.

:func:`maybe_initialize` then calls ``torch.distributed.
init_process_group`` with the coordinator as a ``tcp://`` rendezvous
(under ``torchrun`` the workers' store client connects to the agent's
store at ``MASTER_ADDR:MASTER_PORT``). Nothing here switches backend or
device by itself: the device is ``cuda:{local_rank}`` unless the caller
names one, and a local rank with no card of its own raises.
"""

from __future__ import annotations

import datetime
import os
import re
from dataclasses import dataclass
from typing import List, Optional

import torch

from oktopk_tpu_torch import resolve_device

DEFAULT_PORT = 8476
DEFAULT_TIMEOUT_S = 300.0
LOCAL_RANK_VARS = ("LOCAL_RANK", "SLURM_LOCALID",
                   "OMPI_COMM_WORLD_LOCAL_RANK")


@dataclass(frozen=True)
class ProcessEnv:
    """One process's place in the job."""

    process_id: int
    num_processes: int
    coordinator: Optional[str]  # "host:port" or None
    source: str                 # which discovery rule fired
    local_rank: int = 0

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def expand_nodelist(nodelist: str) -> List[str]:
    """Expand a compact SLURM nodelist ("nid0[1234-1236,1240],login1")
    into hostnames, without ``scontrol show hostnames``."""
    hosts: List[str] = []
    parts, depth, cur = [], 0, []
    for ch in nodelist:       # split on commas outside brackets
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))

    for part in parts:
        m = re.fullmatch(r"([^\[\]]*)\[([^\]]+)\](.*)", part)
        if not m:
            if part:
                hosts.append(part)
            continue
        prefix, body, suffix = m.groups()
        for item in body.split(","):
            if "-" in item:
                lo, hi = item.split("-", 1)
                width = len(lo)
                for i in range(int(lo), int(hi) + 1):
                    hosts.append(f"{prefix}{i:0{width}d}{suffix}")
            else:
                hosts.append(f"{prefix}{item}{suffix}")
    return hosts


def _with_port(coord: Optional[str], port: int) -> Optional[str]:
    if coord and ":" not in coord:
        return f"{coord}:{port}"
    return coord


def _local_rank(e) -> int:
    for var in LOCAL_RANK_VARS:
        if var in e:
            return int(e[var])
    return 0


def discover(env: Optional[dict] = None,
             port: int = DEFAULT_PORT) -> ProcessEnv:
    """This process's coordinates, by the rules of the module docstring."""
    e = os.environ if env is None else env
    local = _local_rank(e)

    if "OKTOPK_NUM_PROCS" in e:
        nprocs = int(e["OKTOPK_NUM_PROCS"])
        if nprocs > 1 and "OKTOPK_PROC_ID" not in e:
            # every host would claim process 0 and the rendezvous would
            # wait for the missing ranks
            raise RuntimeError(
                "OKTOPK_NUM_PROCS > 1 but OKTOPK_PROC_ID is unset; export a "
                "distinct OKTOPK_PROC_ID in [0, num_procs) on each host")
        return ProcessEnv(
            process_id=int(e.get("OKTOPK_PROC_ID", "0")),
            num_processes=nprocs,
            coordinator=_with_port(e.get("OKTOPK_COORDINATOR"), port),
            source="explicit", local_rank=local)

    if "SLURM_NTASKS" in e and "SLURM_PROCID" in e:
        nodelist = e.get("SLURM_STEP_NODELIST", e.get("SLURM_NODELIST", ""))
        hosts = expand_nodelist(nodelist) if nodelist else []
        return ProcessEnv(
            process_id=int(e["SLURM_PROCID"]),
            num_processes=int(e["SLURM_NTASKS"]),
            coordinator=f"{hosts[0]}:{port}" if hosts else None,
            source="slurm", local_rank=local)

    if "OMPI_COMM_WORLD_SIZE" in e:
        coord = _with_port(e.get("OKTOPK_COORDINATOR"), port)
        if coord is None and int(e["OMPI_COMM_WORLD_SIZE"]) > 1:
            raise RuntimeError(
                "OpenMPI launch detected but OKTOPK_COORDINATOR is unset; "
                "export OKTOPK_COORDINATOR=<rank-0 host> on every rank "
                "(an OpenMPI launch names no rendezvous of its own)")
        return ProcessEnv(
            process_id=int(e["OMPI_COMM_WORLD_RANK"]),
            num_processes=int(e["OMPI_COMM_WORLD_SIZE"]),
            coordinator=coord, source="openmpi", local_rank=local)

    if "WORLD_SIZE" in e and "RANK" in e:
        addr = e.get("MASTER_ADDR")
        coord = (f"{addr}:{e.get('MASTER_PORT', port)}" if addr else None)
        return ProcessEnv(
            process_id=int(e["RANK"]), num_processes=int(e["WORLD_SIZE"]),
            coordinator=coord, source="torchrun", local_rank=local)

    return ProcessEnv(process_id=0, num_processes=1, coordinator=None,
                      source="single", local_rank=local)


def local_device(penv: ProcessEnv, device=None) -> torch.device:
    """The named device, else ``cuda:{local_rank}``; raises when the
    local rank has no card of its own (never folds ranks onto card 0)."""
    if device is not None:
        return resolve_device(device)
    dev = resolve_device(f"cuda:{penv.local_rank}")
    count = torch.cuda.device_count()
    if penv.local_rank >= count:
        raise RuntimeError(
            f"local rank {penv.local_rank} has no card: this host has "
            f"{count}; start at most {count} processes per host, or name "
            "the device")
    return dev


def maybe_initialize(backend: str, device=None, env: Optional[dict] = None,
                     port: int = DEFAULT_PORT,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     init_method: Optional[str] = None):
    """``(ProcessEnv, device)``; on a multi-process launch, first joins
    the process group (``init_process_group(backend, init_method, rank,
    world_size, timeout)``). Idempotent, and a no-op for one process.
    ``init_method`` overrides the ``tcp://`` rendezvous at the
    coordinator (for example a ``file://`` store)."""
    import torch.distributed as dist

    penv = discover(env, port)
    dev = local_device(penv, device)
    if penv.num_processes <= 1 or dist.is_initialized():
        return penv, dev
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
    if init_method is None:
        if penv.coordinator is None:
            raise RuntimeError(
                f"{penv.source} launch of {penv.num_processes} processes "
                "without a coordinator address")
        init_method = f"tcp://{penv.coordinator}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=penv.process_id,
        world_size=penv.num_processes,
        timeout=datetime.timedelta(seconds=timeout_s))
    return penv, dev


def data_parallel(num_workers: Optional[int] = None, device=None,
                  backend: Optional[str] = None):
    """``(ProcessEnv, device, comm, workers)`` of a training CLI. One
    process: comm None (the trainer stacks ``num_workers`` workers, 1 by
    default, on its device). A multi-process launch: joins the group
    (``maybe_initialize``; backend nccl on a card, gloo on the CPU,
    unless named) and returns a ``ProcessGroupComm``, the world size
    being the number of workers (``num_workers`` must be None or
    equal to it)."""
    from oktopk_tpu_torch.comm import ProcessGroupComm

    penv = discover()
    dev = local_device(penv, device)
    if penv.num_processes <= 1:
        return penv, dev, None, num_workers or 1
    if num_workers not in (None, penv.num_processes):
        raise ValueError(
            f"--num-workers {num_workers} on a launch of "
            f"{penv.num_processes} processes: one worker per process")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    penv, dev = maybe_initialize(backend, dev)
    return penv, dev, ProcessGroupComm(), penv.num_processes
