"""A process group seen from one rank (counterpart of parallel/mesh.py).

The reference runs one process over a JAX device mesh.  The port runs one
process a device under torch.distributed: NCCL between cards, gloo
between CPU ranks (parallel/launch.py starts them).  A ``Mesh`` is one
rank's view of its group: the group, the rank, the group's size and the
device the rank's tensors live on.

It carries the three collectives the sharded NTT, MSM and prover need,
and no other:

* ``all_to_all``: (d, ...) words, block s sent to rank s, block s of the
  result received from rank s (the shard axis leads, contiguous, as
  ``all_to_all_single`` splits dimension 0);
* ``all_gather``: every rank's words, stacked (d, ...) in rank order;
* ``broadcast_ints``: a few host ints (below 2^256) from one rank.

Words travel as int32, the port's word type on the card and on the CPU
(gloo refuses torch.uint32).  Each collective adds one call and the bytes
this rank hands in to ``COLLECTIVES[name]``, read and reset as the kernel
wrappers' ``LAUNCHES`` are, and runs in a phase scope
``collective::<name>`` (utils/timers.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..ops.limbs import FR_SPEC, ints_to_words, words_to_ints
from ..utils.timers import phase

#: calls and bytes handed in by this rank, by collective, since the last
#: reset (read by the dry run and the card tests)
COLLECTIVES = {name: {"calls": 0, "bytes": 0}
               for name in ("all_to_all", "all_gather", "broadcast")}

#: the backend each device type takes; there is no other pairing
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def reset_collectives() -> None:
    for counts in COLLECTIVES.values():
        counts["calls"] = counts["bytes"] = 0


def _count(name: str, t: torch.Tensor) -> None:
    COLLECTIVES[name]["calls"] += 1
    COLLECTIVES[name]["bytes"] += t.numel() * t.element_size()


@dataclass(frozen=True)
class Mesh:
    """This rank of a process group: ``group`` (None for the default
    group), ``rank``, ``size`` and the ``device`` its tensors live on."""

    group: object
    rank: int
    size: int
    device: torch.device

    def _words(self, t: torch.Tensor, what: str) -> torch.Tensor:
        if t.dtype != torch.int32 or t.device != self.device:
            raise ValueError(f"{what}: needs int32 words on {self.device}, "
                             f"got {t.dtype} on {t.device}")
        return t.contiguous()

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """(d, ...) -> (d, ...): out[s] is rank s's send[rank]."""
        send = self._words(send, "all_to_all")
        if send.shape[0] != self.size:
            raise ValueError(f"all_to_all: leading axis {send.shape[0]} != "
                             f"{self.size} ranks")
        recv = torch.empty_like(send)
        with phase("collective::all_to_all"):
            dist.all_to_all_single(recv, send, group=self.group)
        _count("all_to_all", send)
        return recv

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(...) -> (d, ...): out[s] is rank s's x."""
        x = self._words(x, "all_gather")
        out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        with phase("collective::all_gather"):
            dist.all_gather(list(out.unbind(0)), x, group=self.group)
        _count("all_gather", x)
        return out

    def broadcast_ints(self, values, src: int = 0) -> list:
        """Rank ``src``'s ints (each below 2^256) on every rank; every rank
        passes as many values."""
        words = torch.from_numpy(ints_to_words(values, FR_SPEC.L)).to(
            self.device)
        with phase("collective::broadcast"):
            dist.broadcast(words, src=src, group=self.group)
        _count("broadcast", words)
        return words_to_ints(words.cpu().numpy())


def make_mesh(device=None) -> Mesh:
    """This rank of the process group already initialised (by
    parallel/launch.py or the caller).  ``device`` defaults to the current
    card under NCCL and the CPU under gloo; a device the backend does not
    serve, or a card other than the current one, raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start the ranks "
                           "with parallel.launch.run_ranks or call "
                           "torch.distributed.init_process_group first")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if BACKENDS.get(device.type) != backend:
        raise RuntimeError(f"make_mesh: a {backend} group cannot serve "
                           f"{device}")
    if device.type == "cuda":
        current = torch.cuda.current_device()
        if device.index is None:
            device = torch.device("cuda", current)
        if device.index != current:
            raise RuntimeError(f"make_mesh: {device} is not this rank's "
                               f"current card cuda:{current}")
    return Mesh(None, dist.get_rank(), dist.get_world_size(), device)

