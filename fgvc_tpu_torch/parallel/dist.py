"""Multi-process coordination of the port (fgvc_tpu/parallel/dist.py).

Evaluation: the reference's collect_results.  Each process evaluates the
videos [rank::world] and the per-video results are exchanged as pickled host
objects before every process scores the whole set, over a gloo group (only
host objects cross it, and NCCL refuses two ranks on one card, which a
machine with one card runs).

Training (data-parallel, the reference's DDP + SyncBN and the JAX
package's 'data' mesh): `initialize_training` has the ranks exchange their
cards (host and card UUID) and picks NCCL where every rank has a card of its
own, gloo on the CPU or where two ranks share a card; the
gradients, the global-batch BatchNorm statistics and the losses cross it
through `all_sum` / `all_sum_grad` / `all_mean_`, the stop decision through
`sync_stop` (fgvc_tpu/apis/train.py _sync_stop), the validation metrics
through `broadcast_object`.  Single-process runs pass through without a
group.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import socket
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


_ALONE = {"depth": 0}


def process_info():
    """(rank, world): the process group's where one is initialised (and no
    `alone` block is open), else (0, 1)."""
    if dist.is_available() and dist.is_initialized() and not _ALONE["depth"]:
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@contextlib.contextmanager
def alone():
    """Inside the block this process acts as a group of one: no collective
    is issued (process 0's mid-training validation, which the other
    processes do not join)."""
    _ALONE["depth"] += 1
    try:
        yield
    finally:
        _ALONE["depth"] -= 1


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str = "gloo") -> None:
    """Join the group of `num_processes` processes whose rank 0 listens at
    `coordinator` ('host:port'); this process is `process_id`.  A backend
    that fails to start raises; there is no fallback to another."""
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def coordinates_from_flags(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Optional[Tuple[str, int, int]]:
    """(coordinator, num_processes, process_id) from CLI flags, falling back
    to the FGVC_* variables that cli/launch.py sets for each rank (explicit
    flags win); None where neither names a coordinator."""
    coordinator = coordinator or os.environ.get("FGVC_COORDINATOR")
    if not coordinator:
        return None
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
    return coordinator, num_processes, process_id


def initialize_from_flags(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """The evaluation's multi-process init (a gloo group) from CLI flags or
    the FGVC_* variables; returns False (and does nothing) where neither
    names a coordinator."""
    coords = coordinates_from_flags(coordinator, num_processes, process_id)
    if coords is None:
        return False
    initialize(*coords)
    return True


def group_backend() -> Optional[str]:
    """The process group's backend ('gloo', 'nccl'), None without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def rank_device(device: str, rank: int) -> str:
    """The device of training rank `rank`: 'cpu' where asked, else
    cuda:(rank % cards)."""
    if device == "cpu":
        return "cpu"
    return f"cuda:{rank % max(torch.cuda.device_count(), 1)}"


def card_of(device: str) -> str:
    """The card that a rank's device names, comparable across hosts: 'cpu',
    or this host's name and the card's UUID (its index where the build does
    not report one)."""
    if device == "cpu":
        return "cpu"
    uuid = getattr(torch.cuda.get_device_properties(torch.device(device)), "uuid", None)
    return f"{socket.gethostname()}/{bytes(uuid.bytes).hex() if hasattr(uuid, 'bytes') else device}"


def training_backend(cards: Sequence[str]) -> str:
    """'nccl' where every rank has a card of its own (`cards`, one card_of
    a rank), 'gloo' on the CPU or where two ranks share a card (NCCL
    refuses two ranks on one)."""
    if "cpu" in cards or len(set(cards)) < len(cards):
        return "gloo"
    return "nccl"


def exchange_cards(store, num_processes: int, process_id: int, card: str) -> List[str]:
    """Every rank's card, in rank order, through the group's store (each
    rank sets its key and waits for the others')."""
    store.set(f"fgvc_card/{process_id}", card)
    return [store.get(f"fgvc_card/{r}").decode() for r in range(num_processes)]


def initialize_training(coordinator: str, num_processes: int, process_id: int,
                        device: str) -> str:
    """Join the training group and return its backend: the ranks first
    exchange their cards over the group's TCP store (rank 0 listens at
    `coordinator`), so every rank picks the same backend from where all of
    them run, on one host or several.  NCCL that fails to start raises;
    there is no fallback to gloo."""
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0)
    backend = training_backend(exchange_cards(store, num_processes, process_id,
                                              card_of(device)))
    dist.init_process_group(backend, store=store, world_size=num_processes, rank=process_id)
    return backend


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


# --------------------------------------------------------------------- #
# data-parallel training


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over every process (a new tensor; `t` itself where
    there is one process).  No gradient flows through it."""
    if process_info()[1] == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


class _AllSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward is all_reduce(SUM) of the cotangent:
    the transpose of a sum over processes, as jax.lax.psum differentiates."""

    @staticmethod
    def forward(ctx, x):
        out = x.detach().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """all_sum with gradients: every process's cotangents of the sum reach
    each process's `t`."""
    if process_info()[1] == 1:
        return t
    return _AllSum.apply(t)


def all_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the processes, in place: one
    all_reduce of their concatenation (the gradient exchange of a step)."""
    world = process_info()[1]
    if world == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(world)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every process's equal-sized leading slice, concatenated in rank order
    (an all_reduce of zero-padded slices, which gloo runs on CUDA tensors
    too); gradients reach each process's slice."""
    rank, world = process_info()
    if world == 1:
        return x
    n = x.shape[0]
    before = x.new_zeros((rank * n, *x.shape[1:]))
    after = x.new_zeros(((world - rank - 1) * n, *x.shape[1:]))
    return all_sum_grad(torch.cat([before, x, after]))


def sync_stop(local_flag: bool, device: Optional[torch.device] = None) -> bool:
    """Any process's stop flag, agreed by all (fgvc_tpu/apis/train.py
    _sync_stop): every process calls it every step, so all stop at one step
    boundary.  `device` is where the backend reduces (the card under NCCL)."""
    if process_info()[1] == 1:
        return local_flag
    flag = torch.tensor([1 if local_flag else 0], dtype=torch.int32,
                        device=device if device is not None else "cpu")
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """`obj` of process `src` on every process."""
    if process_info()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    if process_info()[1] > 1:
        dist.barrier()
