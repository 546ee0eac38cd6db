"""The process group of a multi-rank port: ``torch.distributed``.

Counterpart of ``fasttalk_tpu/parallel/distributed.py``, with the same
settings: ``TPU_COORDINATOR_ADDR`` (host:port of rank 0's store),
``TPU_NUM_PROCESSES`` (the world size) and ``TPU_PROCESS_ID`` (this
rank). Configured, a failure to come up is fatal (a misconfiguration);
with nothing configured ``maybe_initialize`` does nothing, so one-device
serving never pays for a coordinator. (The JAX package's TPU pod
auto-discovery has no counterpart.)

One rank drives one device (the torch idiom, and what NCCL requires):
rank r takes ``cuda:(local rank % device count)``. The backend follows
that layout, never a failure: at the rendezvous every rank writes the
UUID of its card to the store and reads everyone's, and the world takes
``nccl`` when every rank has a card of its own, ``gloo`` when a rank is
on the CPU or two ranks share a card (NCCL refuses two ranks on one
device). The choice and its reason are logged. Gloo moves host tensors only; the
collectives (parallel/collectives.py) stage CUDA tensors through pinned
host buffers for it.
"""

from __future__ import annotations

import datetime
import os

import torch

from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("parallel.distributed")

_initialized = False
# How long a rank waits for the others at the rendezvous and in a
# collective before the process group reports a failure.
_TIMEOUT_S = 300.0


def local_rank() -> int:
    """This process's index among the ranks of its host (``LOCAL_RANK``,
    else ``TPU_PROCESS_ID``: the ranks of one host are numbered first)."""
    return int(os.environ.get("LOCAL_RANK")
               or os.environ.get("TPU_PROCESS_ID") or "0")


def rank_device() -> torch.device:
    """The device this rank drives: ``cuda:(local rank % device count)``
    when there is a card, else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def card_id(device: torch.device) -> str | None:
    """The identity of the card behind ``device`` (its UUID; None for the
    CPU), the same string in every process that drives that card."""
    if device.type != "cuda":
        return None
    return f"GPU-{torch.cuda.get_device_properties(device).uuid}"


def choose_backend(cards: list[str | None]) -> tuple[str, str]:
    """The backend for a world whose rank r drives ``cards[r]`` (from
    ``card_id``), and why: ``nccl`` when every rank has a card of its own,
    ``gloo`` when a rank runs on the CPU or two ranks share a card (NCCL
    refuses two ranks on one device)."""
    if any(c is None for c in cards):
        cpu = [r for r, c in enumerate(cards) if c is None]
        return "gloo", f"ranks {cpu} have no card"
    seen: dict[str, int] = {}
    for r, c in enumerate(cards):
        if c in seen:
            return "gloo", f"ranks {seen[c]} and {r} share card {c}"
        seen[c] = r
    return "nccl", f"each of the {len(cards)} ranks has a card of its own"


def _layout(store, rank: int, world: int) -> list[str | None]:
    """Every rank's card, exchanged through the rendezvous store, so that
    all ranks decide the backend from the same facts."""
    me = card_id(rank_device())
    store.set(f"fasttalk/card/{rank}", me or "")
    return [store.get(f"fasttalk/card/{r}").decode() or None
            for r in range(world)]


def maybe_initialize() -> bool:
    """Bring the process group up when configured. Returns True when
    running (or already running) with more than one rank."""
    global _initialized
    import torch.distributed as dist

    if _initialized or (dist.is_available() and dist.is_initialized()):
        _initialized = True
        return True
    coordinator = os.environ.get("TPU_COORDINATOR_ADDR", "")
    nprocs = os.environ.get("TPU_NUM_PROCESSES", "")
    pid = os.environ.get("TPU_PROCESS_ID", "")
    timeout = datetime.timedelta(seconds=_TIMEOUT_S)
    if not (coordinator and nprocs):
        return False
    # Explicitly configured: a failure here is a misconfiguration and must
    # be fatal.
    world, rank = int(nprocs), int(pid or 0)
    try:
        host, port = coordinator.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                              timeout=timeout)
        backend, why = choose_backend(_layout(store, rank, world))
        if backend == "nccl":
            torch.cuda.set_device(rank_device())
        dist.init_process_group(backend, store=store, world_size=world,
                                rank=rank, timeout=timeout)
    except Exception as e:
        log.error(f"torch.distributed.init_process_group failed: {e}")
        raise
    _initialized = True
    log.info(f"distributed runtime up: backend {backend} ({why})",
             process_index=dist.get_rank(),
             process_count=dist.get_world_size(),
             backend=backend, device=str(rank_device()))
    return True


def process_info() -> dict:
    """The JAX package's keys: with one rank per device, the global device
    count is the world size and each process drives one device."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "global_device_count": dist.get_world_size() if up else 1,
        "local_device_count": 1,
        "initialized": _initialized,
    }


def shutdown() -> None:
    """Tear the process group down (a no-op when it is not up)."""
    global _initialized
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
