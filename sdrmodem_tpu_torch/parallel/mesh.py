"""A one-axis device mesh and the three collectives the sharded demod uses.

The port's counterpart of ``jax.sharding.Mesh`` and of what
``sdrmodem_tpu/parallel/time_shard.py`` does through it: ``jax.lax.ppermute``
one shard to the right (``ring_shift``), ``_put`` (``put``) and ``_fetch``
(``fetch``).

A ``Mesh`` is an ordered list of devices, one a shard.  A device may repeat,
so several shards can sit on one card or on the CPU: that is how the tests
and a one-card machine run it, every shard's launches then queuing on that
card's stream.  With a ``torch.distributed`` process group the mesh spans
processes: ``devices`` are this rank's shards, a contiguous run of the
global ring (rank r owns shards [r * L, (r + 1) * L) of L * world), every
rank holding the same number.

Within one process nothing here waits for a device until ``fetch``: no
``.item()``, no ``.cpu()``, and copies between devices are queued with
``non_blocking=True``, so on several cards each card's launches overlap.
Across processes ``ring_shift`` sends through the group's backend, which
the caller named when it made the group: NCCL sends device tensors; gloo
takes CPU tensors, so a card's tensor is staged through host memory, and
the mesh says so (``staged``).
"""

from __future__ import annotations

import numpy as np
import torch

from sdrmodem_tpu_torch.ops._build import resolve_device
from sdrmodem_tpu_torch.utils.tree import flatten, unflatten


def _to(x, device):
    """A tensor or (named) tuple of tensors on ``device``, queued."""
    return unflatten(x, [t.to(device, non_blocking=True) for t in flatten(x)])


class Mesh:
    """An ordered list of devices, one a shard, along the axis ``axis``.

    ``devices`` defaults to every visible CUDA device (raising without a
    card).  ``group`` is an initialised ``torch.distributed`` process group
    (``torch.distributed.group.WORLD`` for the default one); without it the
    mesh is this process's ``devices`` alone."""

    def __init__(self, devices=None, axis: str = "time", *, group=None):
        if devices is None:
            resolve_device(None)  # raises without a card
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        self.group = group
        self.local = len(self.devices)
        if group is None:
            self.rank, self.world, self.backend = 0, 1, None
        else:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
            self.backend = str(dist.get_backend(group))
        self.size = self.local * self.world
        self.first = self.rank * self.local  # the global index of this rank's first shard

    @property
    def shards(self) -> range:
        """The global indices of this rank's shards."""
        return range(self.first, self.first + self.local)

    @property
    def staged(self) -> bool:
        """Whether shards on a card cross processes through host memory
        (gloo, which sends CPU tensors)."""
        return self.backend == "gloo" and any(d.type == "cuda" for d in self.devices)

    def ring_shift(self, xs: list) -> list:
        """``jax.lax.ppermute`` with the perm i -> i + 1 mod size: shard i
        gets shard i - 1's value, on shard i's device.  ``xs`` holds this
        rank's shards, each a tensor or a (named) tuple of tensors, every
        shard's of the same shapes."""
        if len(xs) != self.local:
            raise ValueError(f"ring_shift: {len(xs)} values for {self.local} shards")
        moved = [_to(xs[i - 1], self.devices[i]) for i in range(1, self.local)]
        if self.world == 1:
            return [_to(xs[-1], self.devices[0])] + moved
        return [self._from_left_rank(xs[-1])] + moved

    def _from_left_rank(self, last):
        """Send this rank's last shard to the next rank, and take the
        previous rank's last shard, on this rank's first device."""
        import torch.distributed as dist

        nxt = dist.get_global_rank(self.group, (self.rank + 1) % self.world)
        prv = dist.get_global_rank(self.group, (self.rank - 1) % self.world)
        send = [t.cpu() if self.backend == "gloo" else t.contiguous() for t in flatten(last)]
        recv = [torch.empty_like(t) for t in send]
        ops = [dist.P2POp(dist.isend, t, nxt, self.group) for t in send]
        ops += [dist.P2POp(dist.irecv, t, prv, self.group) for t in recv]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return unflatten(last, [t.to(self.devices[0], non_blocking=True) for t in recv])

    def put(self, arr: np.ndarray) -> list[torch.Tensor]:
        """``_put``: this rank's shards of the global host array ``arr``
        (leading axis = the mesh's), each on its shard's device."""
        arr = np.asarray(arr)
        if arr.shape[0] != self.size:
            raise ValueError(f"put: leading axis {arr.shape[0]} for a mesh of {self.size}")
        return [
            torch.from_numpy(np.ascontiguousarray(arr[g])).to(dev, non_blocking=True)
            for g, dev in zip(self.shards, self.devices)
        ]

    def fetch(self, xs: list[torch.Tensor]) -> np.ndarray:
        """``_fetch``: every shard's tensor, gathered to every rank as one
        host array with the mesh's axis leading.  Shards share one shape."""
        local = torch.stack([t.cpu() for t in xs])
        if self.world == 1:
            return local.numpy()
        import torch.distributed as dist

        if self.backend != "gloo":
            local = local.to(self.devices[0])
        parts = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(parts, local, group=self.group)
        return torch.cat([p.cpu() for p in parts]).numpy()
