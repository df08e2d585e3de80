"""The lane split of the full-block step's symbols: the CUDA kernel's
wrapper and its plain version.

No TPU kernel is replaced: the JAX server gathers each lane's symbols on
the host, a numpy slice per (lane, chunk)
(``sdrmodem_tpu/server/session.py``, ``BatchedRxGroup._step_block``).
``pack_lanes(symbols, counts)`` does that gathering on the symbols' device
instead: from the step's symbols (C, n_chunks, K) int8, at any strides
(the step returns them time-major), and counts (C, n_chunks) int32, it
returns

- ``flat``, int8: every lane's valid symbols back to back, in (lane,
  chunk, slot) order, slot k of chunk t of lane l valid while
  k < counts[l, t];
- ``offsets``, (C + 1,) int64: the exclusive scan of the lanes' totals,
  so lane l's symbols are ``flat[offsets[l]:offsets[l + 1]]`` and
  ``flat[:offsets[C]]`` is every lane's, in lane order.

A count is taken clamped to [0, K].  For a CUDA tensor it launches
``csrc/pack.cu`` (two kernels, counted in ``launches``), whose ``flat``
holds C * n_chunks * K bytes with nothing written past ``offsets[C]``; for
a CPU tensor it runs ``pack_lanes_plain``, whose ``flat`` is exactly
``offsets[C]`` long.  Both give the same bytes up to ``offsets[C]``.
"""

from __future__ import annotations

import ctypes

import torch

from sdrmodem_tpu_torch.ops import _build

launches = 0  # kernels launched by pack_lanes on the card; a run resets and reads it

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "pack_forward": [
        _P, _L, _L, _L,  # symbols, its lane, chunk and slot strides
        _P, _L, _L,  # counts, its lane and chunk strides
        _I, _I, _I,  # lanes, n_chunks, K
        _P, _P, _P, _P,  # chunk offsets and lane totals (scratch), flat, offsets
        _P,  # stream
    ],
}


def _check(symbols: torch.Tensor, counts: torch.Tensor) -> None:
    if symbols.dim() != 3 or symbols.dtype != torch.int8:
        raise ValueError(f"pack_lanes: symbols must be int8 (C, n_chunks, K), got {symbols.dtype} "
                         f"{tuple(symbols.shape)}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != tuple(symbols.shape[:2]):
        raise ValueError(f"pack_lanes: counts must be int32 {tuple(symbols.shape[:2])}, got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    if counts.device != symbols.device:
        raise ValueError(f"pack_lanes: counts on {counts.device}, symbols on {symbols.device}")


def pack_lanes_plain(symbols: torch.Tensor, counts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(flat, offsets) in plain PyTorch: the mask of valid slots, taken in
    (lane, chunk, slot) order."""
    _check(symbols, counts)
    c, _, k = symbols.shape
    counts = counts.clamp(0, k)
    flat = symbols[torch.arange(k, device=symbols.device) < counts[..., None]]
    offsets = torch.zeros(c + 1, dtype=torch.int64, device=symbols.device)
    offsets[1:] = counts.sum(1, dtype=torch.int64).cumsum(0)
    return flat, offsets


def pack_lanes(symbols: torch.Tensor, counts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(flat, offsets): the kernel for a CUDA tensor, the plain version for
    a CPU tensor (the module's docstring)."""
    global launches
    if _build.device_kind(symbols, "pack_lanes") == "cpu":
        return pack_lanes_plain(symbols, counts)
    _check(symbols, counts)
    c, n, k = symbols.shape
    dev = symbols.device
    if symbols.numel() == 0:
        return torch.empty(0, dtype=torch.int8, device=dev), torch.zeros(c + 1, dtype=torch.int64, device=dev)
    offsets = torch.empty(c + 1, dtype=torch.int64, device=dev)
    scratch = torch.empty(c * n + c, dtype=torch.int64, device=dev)  # chunk offsets, lane totals
    flat = torch.empty(c * n * k, dtype=torch.int8, device=dev)
    lib = _build.load("pack", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pack_forward(
            symbols.data_ptr(), *symbols.stride(), counts.data_ptr(), *counts.stride(), c, n, k,
            scratch.data_ptr(), scratch[c * n :].data_ptr(), flat.data_ptr(), offsets.data_ptr(),
            stream,
        )
    _build.check(lib, rc, "pack_forward")
    launches += 2
    return flat, offsets
