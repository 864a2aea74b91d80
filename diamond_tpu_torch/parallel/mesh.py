"""Data parallelism over torch.distributed (diamond_tpu/parallel/mesh.py): one process
per card, each holding the whole model, its optimizer state and the data store, and the
rows of every global batch that fall to its rank (NCCL on the card; gloo where
``tpu.distributed.cpu_gloo`` asks for it, and in the CPU tests).

The train steps keep the JAX package's global semantics, which its GSPMD mesh gets from
XLA and which the port makes explicit with collectives:
  * a loss is the mean over the GLOBAL batch: each rank divides its masked sum by the
    global count (taken from the global padding mask every rank holds), so the sum of the
    ranks' gradients is the global gradient, even where the ranks hold different mask
    counts (a mean of per-rank means is not);
  * random draws have global shapes, and each rank takes its rows: the generators are
    seeded alike on every rank, so the same seeds give the same math at any world size;
  * the IC-pool pointer stays one global scalar: the death prefix count of a reset is
    taken over the global batch (``assemble``), and every rank holds the whole pool,
    rank 0's at each swap (``replicate_pool``).

The gradients are summed by one flat all_reduce of each step's gradient (each
micro-step's under accumulation; models/agent.py ``AdamWClip``); every rank then clips
and steps on the same gradient, so the parameters stay equal without a broadcast after
start-up (``replicate``).

One code path: a ``DataParallel`` without a process group is world size 1 and skips
every collective, which is the path a single card runs. A handle made from a process
group issues its collectives at any world size (at world size 1 they give back their
input). Collectives are built from ``all_reduce`` and ``broadcast`` only, the two that
gloo takes on CUDA tensors, and are issued from the main thread only, in the same order
on every rank.

Not carried over: the mesh objects themselves (``make_mesh``, ``batch_sharding``,
``replicated``); ``shard_pool`` becomes ``replicate_pool``, since the pool is whole on
every rank.
"""

from __future__ import annotations

from dataclasses import fields, replace
from typing import Any, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn as nn


def select_devices(spec: Any = "all", count: Optional[int] = None) -> List[int]:
    """Resolve ``common.devices`` into card indices (reference src/main.py:47-56): "all"
    or None, one index, or a sequence of indices, over ``count`` cards
    (``torch.cuda.device_count()`` unless given). Errors on an empty, duplicate or
    out-of-range selection."""
    n = torch.cuda.device_count() if count is None else int(count)
    if spec is None or spec == "all":
        return list(range(n))
    idxs = [spec] if isinstance(spec, int) else list(spec)
    if not idxs:
        raise ValueError("common.devices: empty device selection")
    out: List[int] = []
    for i in idxs:
        i = int(i)
        if not 0 <= i < n:
            raise ValueError(f"common.devices: index {i} out of range — {n} device(s) "
                             "visible")
        if i in out:
            raise ValueError(f"common.devices: duplicate index {i}")
        out.append(i)
    return out


class DataParallel:
    """This process's place in the data-parallel group: its ``rank``, the ``world``
    size, its ``device`` and the process ``group`` (None: one process, no collective)."""

    def __init__(self, device: Union[str, torch.device] = "cpu",
                 group: Optional[dist.ProcessGroup] = None) -> None:
        self.device = torch.device(device)
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world = dist.get_world_size(group) if group is not None else 1

    @classmethod
    def from_process_group(cls, device: Union[str, torch.device]) -> "DataParallel":
        """The handle of the default process group (``init_process_group`` first)."""
        if not dist.is_initialized():
            raise RuntimeError("DataParallel.from_process_group: no process group")
        return cls(device, dist.group.WORLD)

    @property
    def active(self) -> bool:
        """Whether collectives are issued."""
        return self.group is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def __repr__(self) -> str:
        return f"DataParallel(rank={self.rank}, world={self.world}, device={self.device})"

    # -- rows of the global batch ----------------------------------------------

    def rows(self, b: int) -> slice:
        """This rank's rows of a global batch of ``b``; ``b`` must divide over the ranks,
        as the mesh requires."""
        if b % self.world:
            raise ValueError(f"a global batch of {b} does not divide over {self.world} "
                             "ranks")
        n = b // self.world
        return slice(self.rank * n, (self.rank + 1) * n)

    def take(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of a global tensor along ``dim`` (a view)."""
        if self.world == 1:
            return x
        s = self.rows(x.shape[dim])
        return x.narrow(dim, s.start, s.stop - s.start)

    def assemble(self, x: torch.Tensor) -> torch.Tensor:
        """The global (world * b, ...) tensor of every rank's rows ``x`` (b, ...): zeros
        with this rank's rows written, summed over the ranks."""
        if not self.active:
            return x
        g = x.new_zeros((x.shape[0] * self.world,) + tuple(x.shape[1:]))
        g[self.rows(g.shape[0])] = x
        return self.all_reduce_sum(g)

    # -- collectives ------------------------------------------------------------

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """In place; returns ``x``."""
        if self.active:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        if self.active:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.active:
            dist.broadcast(x, src=src, group=self.group)
        return x

    def _all_reduce_flat(self, tensors: Sequence[torch.Tensor], op) -> int:
        """``op`` over the ranks of ``tensors`` (one dtype), in place, by one all_reduce
        of their flat concatenation. Returns the bytes reduced."""
        tensors = list(tensors)
        if not self.active or not tensors:
            return 0
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=op, group=self.group)
        torch._foreach_copy_(tensors, [v.view_as(t) for v, t in
                                       zip(flat.split([t.numel() for t in tensors]), tensors)])
        return flat.numel() * flat.element_size()

    def all_reduce_sum_flat(self, tensors: Sequence[torch.Tensor]) -> int:
        """Sum ``tensors`` over the ranks in place (one all_reduce); the bytes reduced."""
        return self._all_reduce_flat(tensors, dist.ReduceOp.SUM)

    def all_reduce_max_flat(self, tensors: Sequence[torch.Tensor]) -> int:
        """The elementwise max over the ranks, in place (one all_reduce)."""
        return self._all_reduce_flat(tensors, dist.ReduceOp.MAX)

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """``src``'s picklable ``obj`` on every rank."""
        if not self.active:
            return obj
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=src, group=self.group,
                                   device=self.device if self.device.type == "cuda" else None)
        return box[0]

    def barrier(self) -> None:
        """Every rank waits until all have reached it: an all_reduce of one element
        read back on the host."""
        if self.active:
            self.all_reduce_sum(torch.zeros(1, device=self.device)).item()


def replicate(module: nn.Module, dp: DataParallel) -> nn.Module:
    """Rank 0's parameters and buffers on every rank (one broadcast each, at start-up)."""
    if dp.active:
        with torch.no_grad():
            for t in module.state_dict().values():
                dp.broadcast(t)
    return module


def shard_device_batch(batch, dp: DataParallel):
    """A DeviceBatch of the global batch -> this rank's rows of it, with the global
    padding mask kept beside them (``mask_global``, for the losses' counts)."""
    rows = {f.name: dp.take(getattr(batch, f.name)) for f in fields(batch)
            if f.name != "mask_global"}
    return type(batch)(**rows, mask_global=batch.mask_padding)


def replicate_pool(pool, dp: DataParallel):
    """An ICPool every rank built from the same segments: rank 0's burned-in LSTM state
    and policy features on every rank (a broadcast each; two processes need not burn in
    bit for bit alike on the card). The frames and actions are gathers, alike already.
    Called on the main thread at each swap, in the same order on every rank."""
    for x in (pool.hx, pool.cx, pool.feats):
        if x is not None:
            dp.broadcast(x)
    return pool


def shard_imag_state(st, dp: DataParallel):
    """ImagState: every field is (B, ...) — this rank's env rows."""
    return replace(st, **{f.name: dp.take(getattr(st, f.name)) for f in fields(st)})
