"""Multi-process coordination of the evaluation (fgvc_tpu/parallel/dist.py),
the reference's collect_results: each process evaluates the videos
[rank::world] and the per-video results are exchanged as pickled host
objects before every process scores the whole set.

The processes form a `torch.distributed` group over the gloo backend, never
NCCL: only host objects cross it (a few KB of results per video, no device
tensor), and NCCL refuses two ranks on one card, which a machine with one
card runs (every rank there shares cuda:0).  Single-process runs pass
through without a group.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional

import torch.distributed as dist


def process_info():
    """(rank, world): the process group's where one is initialised, else
    (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(coordinator: str, num_processes: int, process_id: int) -> None:
    """Join the gloo group of `num_processes` processes whose rank 0 listens
    at `coordinator` ('host:port'); this process is `process_id`."""
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def initialize_from_flags(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Multi-process init from CLI flags, falling back to the FGVC_* variables
    that cli/launch.py sets for each rank.  Explicit flags win; returns False
    (and does nothing) where neither names a coordinator."""
    coordinator = coordinator or os.environ.get("FGVC_COORDINATOR")
    if not coordinator:
        return False
    if num_processes is None and os.environ.get("FGVC_NUM_PROCESSES"):
        num_processes = int(os.environ["FGVC_NUM_PROCESSES"])
    if process_id is None and os.environ.get("FGVC_PROCESS_ID"):
        process_id = int(os.environ["FGVC_PROCESS_ID"])
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator!r} given without the number of processes "
            "and this process's id (--num-processes/--process-id or "
            "FGVC_NUM_PROCESSES/FGVC_PROCESS_ID)"
        )
    initialize(coordinator, num_processes, process_id)
    return True


def finalize() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _allgather_bytes(payload: bytes) -> List[bytes]:
    """One byte string from every process, in rank order."""
    out: List[Optional[bytes]] = [None] * process_info()[1]
    dist.all_gather_object(out, payload)
    return out


def allgather_objects(objs: list, _gather_bytes=None) -> list:
    """The concatenation, in rank order, of every process's list of picklable
    objects; a single process's list passes through.  `_gather_bytes`
    replaces the exchange (tests)."""
    _, world = process_info()
    if world == 1 and _gather_bytes is None:
        return list(objs)
    gather = _gather_bytes or _allgather_bytes
    merged: list = []
    for raw in gather(pickle.dumps(objs)):
        merged.extend(pickle.loads(raw))
    return merged


def allgather_summaries(summaries: List[Dict[str, float]]) -> List[Dict[str, float]]:
    """Every process's per-point summary dicts, in rank order (JSON
    payloads)."""
    _, world = process_info()
    if world == 1:
        return summaries
    merged: List[Dict[str, float]] = []
    for raw in _allgather_bytes(json.dumps(summaries).encode()):
        merged.extend(json.loads(raw))
    return merged
