"""GFSK/GMSK modulator: bytes -> NRZ -> Gaussian polyphase FIR -> VCO.

Counterpart of ``sdrmodem_tpu/dsp/gfsk_mod.py`` (reference
src/dsp/gfsk_mod.c:43-132):

- pulse taps = gaussian(4*sps taps, BT) convolved with ones(int(sps));
- bytes expand MSB first to +-1.0 NRZ at one sample a bit;
- an interpolating polyphase FIR by int(sps) (``dsp/fir.py``);
- a frequency modulator with sensitivity 2*pi*deviation/Fs (set at
  reference src/tcp_server.c:529).

``process`` and ``process_pair`` run the unfused chain in plain PyTorch;
``process_pair_kernel`` runs the TX kernels (``ops/tx.py``): B5 for one
stream, B6 for a (C, N) batch.  The modulator lives on one device, CUDA
unless ``device="cpu"`` is given, where the kernels' plain versions run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp import taps as taps_mod
from sdrmodem_tpu_torch.dsp.elementwise import (
    bytes_to_nrz,
    freq_mod_stream,
    freq_mod_stream_pair,
)
from sdrmodem_tpu_torch.dsp.fir import interp_fir_stream
from sdrmodem_tpu_torch.ops._build import resolve_device
from sdrmodem_tpu_torch.ops import tx as tx_ops

__all__ = ["GfskModConfig", "GfskModulator", "bytes_to_nrz"]

MAX_STREAMS = 128  # process_pair_kernel's batch limit, as in the JAX package


@dataclass(frozen=True)
class GfskModConfig:
    samples_per_symbol: float
    sensitivity: float
    bt: float = 0.5

    @classmethod
    def from_radio(cls, sampling_freq: int, baud_rate: int, deviation: int, bt: float = 0.5):
        """Derive from radio parameters as the reference server does."""
        return cls(
            samples_per_symbol=float(np.float32(sampling_freq / baud_rate)),
            sensitivity=float(np.float32(2.0 * np.pi * deviation / sampling_freq)),
            bt=bt,
        )


class GfskModulator:
    """Whole-stream GFSK modulator; channels batch on a leading axis."""

    def __init__(self, config: GfskModConfig, *, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.interpolation = int(config.samples_per_symbol)
        self.taps = taps_mod.gfsk_pulse_taps(config.samples_per_symbol, config.bt)
        self.k = -(-len(self.taps) // self.interpolation)  # taps a polyphase phase

    def _bytes(self, data) -> torch.Tensor:
        """data (bytes, an array or a tensor) as uint8 on the modulator's device."""
        if isinstance(data, (bytes, bytearray)):
            data = np.frombuffer(bytes(data), np.uint8)
        elif not isinstance(data, torch.Tensor):
            data = np.asarray(data, np.uint8)
        return torch.as_tensor(data, dtype=torch.uint8, device=self.device)

    def _filtered(self, data) -> torch.Tensor:
        return interp_fir_stream(bytes_to_nrz(self._bytes(data)), self.taps, self.interpolation)

    def process(self, data, phase0=0.0):
        """data: uint8 (..., N) -> (complex64 (..., N*8*int(sps)), next phase)."""
        return freq_mod_stream(self._filtered(data), self.config.sensitivity, phase0)

    def process_pair(self, data, phase0=0.0, *, exact: bool = False):
        """uint8 (..., N) -> (I, Q float32 (..., N*8*int(sps)), next phase).
        ``exact=False`` takes the VCO as the two-level float32 prefix
        (``freq_mod_pair_fast``), ``exact=True`` in float64."""
        return freq_mod_stream_pair(self._filtered(data), self.config.sensitivity, phase0,
                                    exact=exact)

    def process_pair_kernel(self, data, phase0=None):
        """The whole NRZ -> polyphase -> VCO chain through the TX kernels:
        data uint8 (N,) runs B5 on its packed bytes, (C <= 128, N) runs B6
        with the streams on lanes.  Returns (I, Q, next phase) with I and Q
        shaped like ``data`` expanded to N*8*int(sps) samples (views of the
        kernel's complex64 output) and the phase float64 (a 0-d tensor, or
        (C,)).  The phase prefix is float64, so this follows
        ``process_pair(exact=True)``."""
        data = self._bytes(data)
        sens, interp = self.config.sensitivity, self.interpolation
        if data.dim() == 1:
            hist = torch.zeros(self.k - 1, dtype=torch.float32, device=self.device)
            return tx_ops.gfsk_tx_call_folded(data, self.taps, interp, sens,
                                              0.0 if phase0 is None else float(phase0), hist)
        c = data.shape[0]
        if c > MAX_STREAMS:
            raise ValueError(f"process_pair_kernel handles up to {MAX_STREAMS} streams")
        nrz_tm = bytes_to_nrz(data).T.contiguous()  # (Nbits, C)
        ph = torch.zeros(c, dtype=torch.float64, device=self.device)
        if phase0 is not None:
            ph[:] = torch.as_tensor(phase0, dtype=torch.float64, device=self.device)
        hist = torch.zeros((self.k - 1, c), dtype=torch.float32, device=self.device)
        i_tm, q_tm, phase, _ = tx_ops.gfsk_tx_call(nrz_tm, self.taps, interp, sens, ph, hist)
        return i_tm.T, q_tm.T, phase
