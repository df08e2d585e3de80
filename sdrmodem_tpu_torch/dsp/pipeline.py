"""The batched full-block demodulator step.

Counterpart of ``sdrmodem_tpu/dsp/pipeline.py:58-72, 365-381, 569-676``
(``DemodStateFull``, ``init_full_state`` and ``make_batched_step_full``),
without the Doppler stage: every channel advances by exactly ``block``
samples a step, through the front-end kernel (``ops/front.py``) and the
clock kernel (``ops/clock.py``), and every FIR tail, the one-row quad-demod
carry and the clock's {omega, mu, last, suffix, resid} carry over in
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
from sdrmodem_tpu_torch.ops.front import FrontTaps, fused_front

LAYOUTS = ("cm", "tm", "fanout")


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
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            # tensors report "cuda:N", so name the card the way they do
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
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

    def make_batched_step_full(self, layout: str = "cm"):
        """Batched full-block step: (state, x) -> (state', symbols int8
        (C, n_chunks, K), counts int32 (C, n_chunks)).

        ``layout`` picks the input convention (C = the state's channels):
          - "cm"     x is (C, 2, B), channel-major;
          - "tm"     x is (B, 2C), time-major, I in lanes [0, C) and Q in
                     [C, 2C): the kernels' own layout, no re-layout;
          - "fanout" x is (2, B): one shared IQ stream broadcast to every
                     lane (the reference's sdr_worker fan-out).
        """
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}")
        p = self._clockp

        def step(state: DemodStateFull, x: torch.Tensor):
            c = state.quad_prev.shape[1] // 2
            x_tm = self.to_time_major(x, c, layout)
            y3, front = fused_front(
                x_tm,
                state.lpf1_hist,
                state.quad_prev,
                state.lpf2_hist,
                state.dc_hist,
                self.front_taps,
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
            return DemodStateFull(*front, clock), float_to_int8(outs), counts

        return step
