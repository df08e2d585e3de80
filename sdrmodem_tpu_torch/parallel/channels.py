"""Channel-parallel batched demodulation over a device mesh.

Counterpart of ``sdrmodem_tpu/parallel/channels.py``.  The reference runs
one dsp_worker thread per RX client (src/dsp_worker.c:44-106); here the
channels are the lanes of a batched step, split into equal runs, one a
shard of a ``Mesh`` (``parallel/mesh.py``).  Each shard runs the port's
step on its own device with its own ``DemodPipeline`` (taps, arctangent
table and MMSE bank on that device), so the step needs no collective at
all: channel parallelism is embarrassingly parallel, like the reference's
independent threads.

- ``ShardedChannelDemod``: the ragged step, one block a channel with a
  per-channel ``n_valid`` (``make_batched_step("pallas")``: B3 and B4 on
  the card), where the JAX class vmaps the streamer's step;
- ``ShardedChannelDemodFull``: the production full-block step
  (``make_batched_step_full(clock_backend)``, the fused front: B1 and B2 on
  the card).

The contract is the JAX classes': ``init_state()``, ``place_input(iq)``,
``step(state, x)``, inputs (C, 2, B), outputs (C, K) and (C,), or (C,
n_chunks, K) and (C, n_chunks), and the same ``ValueError`` for the same
arguments.  Lanes inside a shard are not padded.  The state is a list, one
``DemodState`` or ``DemodStateFull`` a shard on its device
(``utils/convert.py:sharded_state_to_numpy`` turns it into the JAX class's
global layout); the outputs come back to the host, one copy a shard, as
CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.parallel.mesh import Mesh


class _Sharded:
    """What both classes share: the channels split over the mesh's
    shards, a pipeline a shard, and the host edges."""

    def __init__(self, config: FskDemodConfig, block_size: int, channels: int, mesh: Mesh, **pipe_kw):
        if channels % mesh.size != 0:
            raise ValueError("channels must divide evenly over the mesh axis")
        self.channels = channels
        self.local = channels // mesh.size
        self.mesh = mesh
        self.block = block_size
        self.pipes = [DemodPipeline(config, block_size, device=d, **pipe_kw) for d in mesh.devices]
        self.pipe = self.pipes[0]

    def place_input(self, iq: np.ndarray) -> list[torch.Tensor]:
        """(C, N) complex64 -> this rank's shards of the (C, 2, N) float32
        pairs, each on its shard's device."""
        x = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
        return self.mesh.put(x.reshape(self.mesh.size, self.local, *x.shape[1:]))

    def _gather(self, *outs) -> tuple[torch.Tensor, ...]:
        """Per-shard outputs led by the shard's channels -> (C, ...) CPU
        tensors, every shard's channels in mesh order."""
        return tuple(
            torch.from_numpy(self.mesh.fetch(o)).reshape(self.channels, *o[0].shape[1:]) for o in outs
        )


class ShardedChannelDemod(_Sharded):
    """N-channel ragged demodulator sharded over a mesh: each shard steps
    its channels through ``make_batched_step("pallas")``."""

    def __init__(self, config: FskDemodConfig, block_size: int, channels: int, mesh: Mesh, *,
                 exact: bool = False, use_atan_lut=True):
        super().__init__(config, block_size, channels, mesh, exact=exact, use_atan_lut=use_atan_lut)
        self._steps = [p.make_batched_step("pallas") for p in self.pipes]

    def init_state(self) -> list:
        return [p.init_state(channels=self.local) for p in self.pipes]

    def step(self, state: list, x_pairs: list, n_valid=None):
        """One block step for all channels: x_pairs from ``place_input``
        ((C, 2, B) in shards), ``n_valid`` (C,) valid samples a channel
        (the whole block when None).  Returns (state', symbols int8 (C,
        K), counts int32 (C,))."""
        if n_valid is None:
            n_valid = np.full(self.channels, self.block, np.int32)
        nv = np.asarray(n_valid, np.int32).reshape(self.mesh.size, self.local)
        outs = [
            step(st, x, torch.from_numpy(nv[g].copy()).to(x.device))
            for step, st, x, g in zip(self._steps, state, x_pairs, self.mesh.shards)
        ]
        symbols, counts = self._gather([o[1] for o in outs], [o[2] for o in outs])
        return [o[0] for o in outs], symbols, counts


class ShardedChannelDemodFull(_Sharded):
    """The full-block fast path sharded over a mesh: each shard runs the
    batched step (``make_batched_step_full(clock_backend)``, the fused
    front) on its run of channels, the production configuration of the
    JAX package's BASELINE (1024 channels = 8 shards x 128).  State leaves
    are channel-last on each shard."""

    def __init__(self, config: FskDemodConfig, block_size: int, channels: int, mesh: Mesh, *,
                 clock_backend: str = "pallas", use_atan_lut=True):
        super().__init__(config, block_size, channels, mesh, exact=False, use_atan_lut=use_atan_lut)
        if self.local % 128 != 0 and channels > 128:
            raise ValueError("per-shard channel count should be a lane multiple")
        self._steps = [p.make_batched_step_full(clock_backend) for p in self.pipes]

    def init_state(self) -> list:
        return [p.init_full_state(self.local) for p in self.pipes]

    def step(self, state: list, x_pairs: list):
        """One full-block step for all channels: x_pairs from
        ``place_input``.  Returns (state', symbols int8 (C, n_chunks, K),
        counts int32 (C, n_chunks))."""
        outs = [step(st, x) for step, st, x in zip(self._steps, state, x_pairs)]
        symbols, counts = self._gather([o[1] for o in outs], [o[2] for o in outs])
        return [o[0] for o in outs], symbols, counts
