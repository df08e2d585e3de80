"""Chunked streaming TX modulator with carried state.

Counterpart of ``sdrmodem_tpu/dsp/streaming.py:StreamingGfskMod``, the
server's TX modulator (``sdrmodem_tpu/server/session.py:687-726``): the
polyphase history and the VCO phase carry across TxData payloads, as the
reference's gfsk_mod state does (src/dsp/gfsk_mod.c,
frequency_modulator.c).

Backend "fused" (the default) runs each payload through B5
(``ops/tx.py:gfsk_tx_folded_iq``, ``csrc/tx.cu``) in four steps:
``stage`` packs [history | payload bytes] into one host buffer, ``upload``
copies it to the device, ``launch`` starts the kernels on the packed bits,
and ``fetch`` copies the complex64 samples back in one piece and carries
the phase and the history.  On the CPU the same call runs the kernel's
plain version.  Backend "xla" keeps the JAX package's name for the unfused
chain (``dsp/fir.py:interp_fir_stream`` then the float64 VCO).  Both carry
the phase in float64, so any chunking of a stream gives the same samples
up to float64 rounding.

The kernel takes any length, so payloads are not padded; a payload longer
than ``MAX_DISPATCH_BYTES`` (the wire protocol's largest TxData, reference
src/api_utils.c:8) is cut into sub-dispatches of that size with the state
carried, which bounds one launch's output.
"""

from __future__ import annotations

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.elementwise import bytes_to_nrz, freq_mod_stream_pair
from sdrmodem_tpu_torch.dsp.fir import interp_fir_stream
from sdrmodem_tpu_torch.dsp.gfsk_mod import GfskModConfig, GfskModulator
from sdrmodem_tpu_torch.ops import tx as tx_ops

BACKENDS = ("fused", "xla")


def _as_bytes(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(bytes(data), np.uint8)
    return np.asarray(data, np.uint8)


class StreamingGfskMod:
    """Chunked GFSK modulator: carried polyphase history + VCO phase."""

    MAX_DISPATCH_BYTES = 32768

    def __init__(self, config: GfskModConfig, backend: str = "fused", device=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown TX backend {backend!r}; one of {BACKENDS}")
        self.mod = GfskModulator(config, device=device)
        self.device = self.mod.device
        self.backend = backend
        self.k = self.mod.k
        self.hist = np.zeros(self.k - 1, np.float32)
        self.phase = 0.0
        self._phase_host = (
            torch.empty((), dtype=torch.float64, pin_memory=True)
            if self.device.type == "cuda" else None
        )

    def load_state(self, phase, hist) -> None:
        """Carry on a stream begun elsewhere, e.g. by the JAX package's
        ``StreamingGfskMod``: its ``phase`` and ``hist`` ((k-1,) NRZ)."""
        hist = np.asarray(hist, np.float32).reshape(-1)
        if hist.shape != (self.k - 1,):
            raise ValueError(f"hist must be ({self.k - 1},), got {hist.shape}")
        self.hist = hist.copy()
        self.phase = float(np.mod(float(phase), 2 * np.pi))

    def process(self, data) -> np.ndarray:
        """One TxData payload (bytes or uint8) -> complex64 samples (numpy)."""
        data = _as_bytes(data)
        if len(data) == 0:
            return np.zeros(0, np.complex64)
        if self.backend != "fused":
            return self._process_xla(data)
        if len(data) > self.MAX_DISPATCH_BYTES:
            return np.concatenate(
                [
                    self.process(data[s : s + self.MAX_DISPATCH_BYTES])
                    for s in range(0, len(data), self.MAX_DISPATCH_BYTES)
                ]
            )
        return self.fetch(self.launch(self.upload(self.stage(data))), data)

    # the fused path's steps, in order
    def stage(self, data: np.ndarray) -> np.ndarray:
        """The host buffer [history as float32 bytes | payload bytes]."""
        h = self.hist.view(np.uint8)
        buf = np.empty(len(h) + len(data), np.uint8)
        buf[: len(h)] = h
        buf[len(h) :] = data
        return buf

    def upload(self, buf: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(buf).to(self.device)

    def launch(self, buf: torch.Tensor):
        """B5 on the staged buffer: (iq complex64 on the device, phase')."""
        nh = 4 * (self.k - 1)
        hist = buf[:nh].view(torch.float32)
        mod = self.mod
        return tx_ops.gfsk_tx_folded_iq(buf[nh:], mod.taps, mod.interpolation,
                                        mod.config.sensitivity, self.phase, hist)

    def fetch(self, launched, data: np.ndarray) -> np.ndarray:
        """The samples on the host; carries the phase and the history."""
        iq, phase = launched
        if self._phase_host is not None:
            self._phase_host.copy_(phase, non_blocking=True)  # done when iq's copy is
            out = iq.cpu().numpy()
            self.phase = float(self._phase_host)
        else:
            out = iq.numpy()
            self.phase = float(phase)
        self._carry_hist(data)
        return out

    def _carry_hist(self, data: np.ndarray) -> None:
        """The last k-1 NRZ rows of [history | payload]."""
        if self.k > 1:
            tail = np.unpackbits(data[-(-(self.k - 1) // 8) :]).astype(np.float32) * 2.0 - 1.0
            self.hist = np.concatenate([self.hist, tail])[-(self.k - 1) :]

    def _process_xla(self, data: np.ndarray) -> np.ndarray:
        mod = self.mod
        nrz = bytes_to_nrz(torch.from_numpy(data.copy()).to(self.device))
        work = torch.cat([torch.from_numpy(self.hist).to(self.device), nrz])
        full = interp_fir_stream(work, mod.taps, mod.interpolation)
        # drop the outputs that belong to the carried history's rows
        out = full[(self.k - 1) * mod.interpolation :]
        i, q, phase = freq_mod_stream_pair(out, mod.config.sensitivity, self.phase)
        self.phase = float(phase)
        self._carry_hist(data)
        return torch.complex(i, q).cpu().numpy()
