"""The batched full-block demodulator step.

Counterpart of ``sdrmodem_tpu/dsp/pipeline.py:58-72, 365-381, 383-474,
569-676`` (``DemodStateFull``, ``init_full_state``, the two fronts and
``make_batched_step_full``): every channel advances by exactly ``block``
samples a step, through an optional per-lane Doppler NCO mix, the front
end (``ops/front.py``: fused, or banded on B3) and the clock kernel
(``ops/clock.py``), and every FIR tail, the one-row quad-demod carry and
the clock's {omega, mu, last, suffix, resid} carry over in
``DemodStateFull``.

The state is time-major with channels along the last axis, unpadded: the
JAX package pads lanes to a multiple of 128 for the TPU, the port does not
(``utils/convert.py`` crosses between the two).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp import taps as taps_mod
from sdrmodem_tpu_torch.dsp.clock_recovery import (
    ClockFullState,
    check_sps_supported,
    clock_mm_batched_full,
    initial_full_state,
)
from sdrmodem_tpu_torch.dsp.elementwise import atan_table, dc_blocker_taps
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig, float_to_int8
from sdrmodem_tpu_torch.ops._build import resolve_device
from sdrmodem_tpu_torch.ops.front import FrontTaps, banded_front, fused_front

LAYOUTS = ("cm", "tm", "fanout")
FRONTS = {"fused": fused_front, "banded": banded_front}


class DemodStateFull(NamedTuple):
    """Carried state of the full-block step (C = channels)."""

    lpf1_hist: torch.Tensor  # (t1-1, 2C) f32, I lanes then Q lanes
    quad_prev: torch.Tensor  # (1, 2C) f32
    lpf2_hist: torch.Tensor  # (t2-1, C) f32
    dc_hist: torch.Tensor | None  # (4L-4, C) f32, None without a DC blocker
    clock: ClockFullState


class DemodPipeline:
    """GMSK demodulator over batches of full blocks, on one device.

    ``device`` defaults to CUDA; pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels."""

    def __init__(self, config: FskDemodConfig, block_size: int, *, device=None):
        self.config = config
        self.block = int(block_size)
        self.device = resolve_device(device)
        self._t1 = np.asarray(config.lpf1_taps(), np.float32)
        self._t2 = np.asarray(config.lpf2_taps(), np.float32)
        self._tdc = (
            np.asarray(dc_blocker_taps(config.dc_length), np.float32)
            if config.use_dc_block
            else None
        )
        self._clockp = config.clock_params()
        check_sps_supported(self._clockp["omega"])
        if self.block % config.decimation != 0:
            raise ValueError("the full-block step requires block % decimation == 0")

        def rev(t):
            return torch.from_numpy(t[::-1].copy()).to(self.device)

        self.front_taps = FrontTaps(
            rev1=rev(self._t1),
            rev2=rev(self._t2),
            rev_dc=rev(self._tdc) if self._tdc is not None else None,
            d=config.decimation,
            quad_gain=config.quad_gain,
            atan_table=atan_table(self.device),
        )
        self.bank = torch.from_numpy(taps_mod.mmse_interp_taps().copy()).to(self.device)

    def init_full_state(self, channels: int) -> DemodStateFull:
        f32 = dict(dtype=torch.float32, device=self.device)
        c = int(channels)
        return DemodStateFull(
            lpf1_hist=torch.zeros((len(self._t1) - 1, 2 * c), **f32),
            quad_prev=torch.zeros((1, 2 * c), **f32),
            lpf2_hist=torch.zeros((len(self._t2) - 1, c), **f32),
            dc_hist=(
                torch.zeros((len(self._tdc) - 1, c), **f32)
                if self._tdc is not None
                else None
            ),
            clock=initial_full_state(
                self._clockp["omega"], c, self._clockp["mu"], device=self.device
            ),
        )

    def to_time_major(self, x: torch.Tensor, channels: int, layout: str) -> torch.Tensor:
        """The step's input in its ``layout`` as the kernels' (B, 2C) layout."""
        b, c = self.block, channels
        want = {"cm": (c, 2, b), "tm": (b, 2 * c), "fanout": (2, b)}[layout]
        if tuple(x.shape) != want or x.dtype != torch.float32 or x.device != self.device:
            raise ValueError(
                f"layout {layout!r} takes float32 {want} on {self.device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if layout == "cm":
            return x.permute(2, 1, 0).reshape(b, 2 * c)
        if layout == "fanout":
            # one shared IQ stream broadcast to every lane
            return torch.cat(
                [x[0][:, None].expand(b, c), x[1][:, None].expand(b, c)], dim=1
            )
        return x.contiguous()

    def make_batched_step_full(
        self, clock_backend: str = "pallas", *, doppler: bool = False, layout: str = "cm",
        front: str = "fused",
    ):
        """Batched full-block step: (state, x) -> (state', symbols int8
        (C, n_chunks, K), counts int32 (C, n_chunks)); with ``doppler=True``
        (state, x, dop) -> the same.  The JAX signature, so the server's
        ``make_batched_step_full("pallas", doppler=True, layout="fanout")``
        (``sdrmodem_tpu/server/session.py:388-390``) runs as written.

        ``clock_backend`` is "pallas", the clock kernel (B2); the JAX
        package's "scan" clock is not ported.

        ``layout`` picks the input convention (C = the state's channels):
          - "cm"     x is (C, 2, B), channel-major;
          - "tm"     x is (B, 2C), time-major, I in lanes [0, C) and Q in
                     [C, 2C): the kernels' own layout, no re-layout;
          - "fanout" x is (2, B): one shared IQ stream broadcast to every
                     lane (the reference's sdr_worker fan-out); per-lane
                     Doppler still sets the lanes apart.

        ``front`` is "fused" (``ops/front.py:fused_front``, B1 from one C
        call) or "banded" (``banded_front``: the same kernels one at a
        time, its FIRs through B3); the two give the same bits.  It is an
        argument, and no environment variable is read.  The JAX package
        falls back to "banded" by itself when a block has no legal TPU tile;
        the port's fused front takes any block with ``block % d == 0``, so
        it never falls back.  "step", the fused front+clock kernel (B7,
        ``sdrmodem_tpu/ops/pallas_step.py``), is not ported yet.

        With ``doppler=True`` the step takes ``dop = (starts, ends, adjs,
        ph0s)``, each an (S, C) float32 tensor on the pipeline's device with
        S >= 1 (rows of ``Doppler.device_segments``), and mixes each lane by
        its rows before LPF1.  Lanes with no active row pass through bit
        for bit.
        """
        if clock_backend == "scan":
            raise NotImplementedError(
                "clock_backend='scan' (the JAX package's lax.scan clock) is not ported; "
                "the port's clock is the B2 kernel, clock_backend='pallas'"
            )
        if clock_backend != "pallas":
            raise ValueError(f"unknown clock_backend {clock_backend!r}")
        if front == "step":
            raise NotImplementedError(
                "front='step' is the fused front+clock kernel B7 "
                "(sdrmodem_tpu/ops/pallas_step.py), which is not ported yet"
            )
        if front not in FRONTS:
            raise ValueError(f"unknown front {front!r}")
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}")
        p = self._clockp
        front_fn = FRONTS[front]

        def step(state: DemodStateFull, x: torch.Tensor, dop=None):
            c = state.quad_prev.shape[1] // 2
            x_tm = self.to_time_major(x, c, layout)
            y3, fstate = front_fn(
                x_tm,
                state.lpf1_hist,
                state.quad_prev,
                state.lpf2_hist,
                state.dc_hist,
                self.front_taps,
                dop,
            )
            outs, counts, clock = clock_mm_batched_full(
                y3,
                state.clock,
                bank=self.bank,
                omega=p["omega"],
                gain_omega=p["gain_omega"],
                mu=p["mu"],
                gain_mu=p["gain_mu"],
                omega_relative_limit=p["omega_relative_limit"],
            )
            return DemodStateFull(*fstate, clock), float_to_int8(outs), counts

        if doppler:
            return step
        return lambda state, x: step(state, x)
