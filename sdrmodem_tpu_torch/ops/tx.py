"""GFSK TX: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``sdrmodem_tpu/ops/pallas_tx.py``: NRZ -> polyphase
Gaussian FIR (interpolation I, k taps a phase) -> VCO phase prefix ->
cos/sin, with the phase carried mod 2*pi and the NRZ history carried
across calls.

- ``gfsk_tx_call_folded`` (B5, ``pallas_tx.py:245``): one stream, the
  server's TX path (``dsp/streaming.py``).  ``gfsk_tx_folded_iq`` is the
  same launch returning the interleaved complex64 samples, which
  ``StreamingGfskMod`` copies to the host in one piece.
- ``gfsk_tx_call`` (B6, ``pallas_tx.py:339``): streams on lanes,
  time-major, a carried phase and history a lane.

Both launch ``csrc/tx.cu`` for a CUDA tensor and run the plain version for
a CPU tensor: one kernel a call where a stream is one tile, else two (a
float64 total a tile, then the samples); ``tx_plan`` gives the runs,
tiles, scratch and launches.  The kernels read each sample's phase as its
NRZ row's start plus one entry of ``pattern_table`` (built once a
configuration on the host, where k <= 8, it fits and every entry is
within 2*pi), and run the FIR chain only on a row whose window is not all
+-1.  The same input gives the same bits on every run (every float64 sum
in a fixed order).
The TPU's shape rules are gone: any N, any lane count, no ``choose_tile``;
``n_valid`` stays (rows at or after it add no phase).  The phase prefix is
float64 in both the kernels and the plain versions (the JAX kernels carry
float32), so the returned phases are float64.  The plain versions share the
kernels' FIR arithmetic (``dsp/fir.py:polyphase_rows``) and take the VCO
from ``dsp/elementwise.py:freq_mod_stream_pair`` (a float64 ``cumsum``):
kernel and plain differ by the float64 summation order and by an ulp of
cos/sin.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.elementwise import bytes_to_nrz, freq_mod_stream_pair
from sdrmodem_tpu_torch.dsp.fir import phase_taps, polyphase_rows
from sdrmodem_tpu_torch.ops import _build

folded_launches = 0  # kernels launched by the B5 wrappers; a run resets and reads it
batched_launches = 0  # kernels launched by gfsk_tx_call (B6)

MAX_SAMPLES = 1 << 30  # n * interpolation a call: the kernels index samples with int
# runs (threads) a B5 tile and runs a lane a B6 tile (csrc/tx.cu kThreads, kBatchRuns); a
# run holds min(MAX_RUN_ROWS, max(1, RUN_SAMPLES // I)) NRZ rows (kFoldRunSamples,
# kBatchRunSamples)
FOLDED_TILE = 256
BATCHED_TILE = 8
RUN_SAMPLES = {"folded": 4, "batched": 32}
MAX_RUN_ROWS = 16  # kMaxRunRows
# the pattern table (``pattern_table``): k at most csrc/tx.cu kTableMaxK (its rows' window
# is a bit mask), 2^k x I float64 at most TABLE_MAX
TABLE_MAX_K = 8
TABLE_MAX = 1 << 16


class TxPlan(NamedTuple):
    """How ``csrc/tx.cu`` cuts one call (its ``plan``), and whether the
    pattern table's size allows it."""

    run: int  # NRZ rows a thread
    tile: int  # NRZ rows a tile: a block's rows of one stream
    tiles: int  # tiles a stream
    scratch: int  # float64 tile totals a stream (0: one launch, no totals)
    launches: int  # kernels a call
    table: bool  # whether the pattern table may be used (else every row runs the chain)


def tx_plan(rows: int, interp: int, k: int, lanes: int | None = None) -> TxPlan:
    """The plan of B5 (``lanes`` None) or B6 over ``rows`` NRZ rows a stream."""
    kind = "folded" if lanes is None else "batched"
    run = min(MAX_RUN_ROWS, max(1, RUN_SAMPLES[kind] // interp))
    tile = (FOLDED_TILE if lanes is None else BATCHED_TILE) * run
    tiles = -(-rows // tile)
    two = tiles > 1
    table = k <= TABLE_MAX_K and (interp << k) <= TABLE_MAX
    return TxPlan(run, tile, tiles, tiles if two else 0, 2 if two else 1, table)


def pattern_table(taps2d: np.ndarray, sensitivity) -> np.ndarray:
    """(2^k, I) float64: entry [p, i] is the sum, in order, of the float32
    increments of phases 0..i on k NRZ rows of +-1, row n - m being +1
    where bit m of p is set.  Each increment is the kernels' chain (one
    rounding a tap from m = k - 1 down to 0, then sens * acc), so an entry
    holds the same float32 increments as the chain on those rows; the
    kernels read a sample's phase as its row's start plus one entry."""
    t = np.asarray(taps2d, np.float32)
    k, ii = t.shape
    sign = np.where((np.arange(1 << k)[:, None] >> np.arange(k)) & 1, 1.0, -1.0).astype(np.float32)
    acc = np.zeros((1 << k, ii), np.float32)
    for m in range(k - 1, -1, -1):
        acc = acc + sign[:, m : m + 1] * t[m]  # +-tap is exact: one float32 rounding, as fmaf
    inc = np.float32(sensitivity) * acc
    return np.cumsum(inc.astype(np.float64), axis=1)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    "tx_folded_forward": [
        _P, _P, _I, _P,  # nrz (or null), bytes (or null), n, hist
        _P, _P, _I, _I, _F, _I,  # taps (k, I), table (or null), k, interpolation, sensitivity,
        # n_valid
        _D, _P, _I, _P, _P,  # phase0, sums scratch and its length, out, phase_out
        _P, _P,  # stream, kernels launched (int out)
    ],
    "tx_batched_forward": [
        _P, _I, _I, _P,  # nrz_tm, n, lanes, hist
        _P, _P, _I, _I, _F, _I,  # taps (k, I), table (or null), k, interpolation, sensitivity,
        # n_valid
        _P, _P, _I, _P, _P, _P,  # phase0 (lanes,), sums scratch (tiles, lanes) and its
        # tiles, out, phase_out, hist_out
        _P, _P,  # stream, kernels launched (int out)
    ],
}
_taps_cache: dict = {}
_table_cache: dict = {}


def _taps2d(taps, interpolation: int, device) -> torch.Tensor:
    """The (k, I) polyphase taps as a float32 tensor on ``device`` (cached)."""
    a = np.asarray(taps.cpu() if isinstance(taps, torch.Tensor) else taps, np.float32)
    key = (a.tobytes(), int(interpolation), str(device))
    t = _taps_cache.get(key)
    if t is None:
        t = _taps_cache[key] = torch.from_numpy(phase_taps(a, interpolation)).to(device)
    return t


def _table(taps, interpolation: int, sensitivity, device) -> torch.Tensor | None:
    """``pattern_table`` on ``device`` (cached), or None where the plan takes
    no table or an entry reaches 2*pi (the kernels keep a table sample's
    phase in [0, 2*pi) with one compare each way)."""
    a = np.asarray(taps.cpu() if isinstance(taps, torch.Tensor) else taps, np.float32)
    key = (a.tobytes(), int(interpolation), _sens(sensitivity), str(device))
    if key not in _table_cache:
        t2d = phase_taps(a, interpolation)
        tab = None
        if tx_plan(1, *t2d.shape[::-1]).table:
            host = pattern_table(t2d, sensitivity)
            if np.abs(host).max() < 2 * np.pi:
                tab = torch.from_numpy(host).to(device)
        _table_cache[key] = tab
    return _table_cache[key]


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _sens(sensitivity) -> float:
    return float(np.float32(sensitivity))


def _rows(nrz: torch.Tensor) -> int:
    """NRZ rows of a float NRZ vector, or of packed bytes (8 a byte)."""
    return nrz.numel() * 8 if nrz.dtype == torch.uint8 else nrz.numel()


def _n_valid(n_valid, n: int) -> int:
    return n if n_valid is None else max(0, min(int(n_valid), n))


def _tx_plain(work, t2d, sensitivity, phase0, n_valid):
    """Plain TX over work = [history (k-1 rows) | NRZ (n rows)], (rows, L)
    float32: the FIR, its rows from n_valid on zeroed, then the float64 VCO
    along time.  Returns (iq (n*I, L) complex64, phase' (L,) float64)."""
    k, ii = t2d.shape
    lanes = work.shape[1]
    n = work.shape[0] - (k - 1)
    y = polyphase_rows(work, t2d, n)  # (n, I, L) float32
    y[n_valid:] = 0.0
    ph0 = torch.as_tensor(phase0, dtype=torch.float64, device=work.device).reshape(-1, 1)
    i, q, phase = freq_mod_stream_pair(y.reshape(n * ii, lanes).T, sensitivity, ph0)
    return torch.complex(i, q).T, phase


def _stream_work(nrz, hist):
    """[history | NRZ] as one (rows, 1) float32 column."""
    x = bytes_to_nrz(nrz) if nrz.dtype == torch.uint8 else nrz.to(torch.float32)
    return torch.cat([hist.to(torch.float32).reshape(-1), x.reshape(-1)])[:, None]


def gfsk_tx_folded_iq_plain(nrz, taps, interpolation, sensitivity, phase0, hist, *, n_valid=None):
    """Plain version of ``gfsk_tx_folded_iq``."""
    t2d = _taps2d(taps, interpolation, nrz.device)
    iq, ph = _tx_plain(_stream_work(nrz, hist), t2d, sensitivity, float(phase0),
                       _n_valid(n_valid, _rows(nrz)))
    return iq[:, 0], ph[0]


def _folded_cuda(nrz, t2d, table, sensitivity, phase0, hist, n_valid):
    dev = nrz.device
    k, ii = t2d.shape
    packed = nrz.dtype == torch.uint8
    n = _rows(nrz)
    total = n * ii
    if total >= MAX_SAMPLES:
        raise ValueError(f"tx: {n} rows x {ii} = {total} samples a call, the kernel takes < 2^30")
    _build.check_arg("tx", "nrz", nrz, (nrz.numel(),), torch.uint8 if packed else torch.float32, dev)
    _build.check_arg("tx", "hist", hist, (k - 1,), torch.float32, dev)
    lib = _build.load("tx", _SIGNATURES)
    out = torch.empty(total, dtype=torch.complex64, device=dev)
    sums = torch.empty(tx_plan(n, ii, k).scratch, dtype=torch.float64, device=dev)
    phase_out = torch.empty((), dtype=torch.float64, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tx_folded_forward(
            None if packed else nrz.data_ptr(), nrz.data_ptr() if packed else None, n,
            hist.data_ptr(), t2d.data_ptr(), _ptr(table), k, ii, _sens(sensitivity), n_valid,
            float(phase0), sums.data_ptr(), sums.numel(), out.data_ptr(), phase_out.data_ptr(),
            stream, ctypes.byref(launched),
        )
    global folded_launches
    folded_launches += launched.value
    _build.check(lib, rc, "tx_folded_forward")
    return out, phase_out


def gfsk_tx_folded_iq(nrz, taps, interpolation, sensitivity, phase0, hist, *, n_valid=None):
    """B5 over one stream: nrz is (N,) float32 NRZ, or (N/8,) uint8 bytes
    whose bits (MSB first, 1 -> +1, 0 -> -1) are the NRZ; taps (T,) in
    natural order; phase0 the carried phase (a float); hist (k-1,) float32
    the carried NRZ history on nrz's device.  Returns (iq (N*I,) complex64,
    phase' 0-d float64 in [0, 2*pi)): the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if _build.device_kind(nrz, "gfsk_tx_folded_iq") == "cpu":
        return gfsk_tx_folded_iq_plain(nrz, taps, interpolation, sensitivity, phase0, hist,
                                       n_valid=n_valid)
    t2d = _taps2d(taps, interpolation, nrz.device)
    n = _rows(nrz)
    if n == 0:
        return (torch.empty(0, dtype=torch.complex64, device=nrz.device),
                torch.tensor(float(phase0) % (2 * np.pi), dtype=torch.float64, device=nrz.device))
    table = _table(taps, interpolation, sensitivity, nrz.device)
    return _folded_cuda(nrz, t2d, table, sensitivity, phase0, hist, _n_valid(n_valid, n))


def gfsk_tx_call_folded(nrz, taps, interpolation, sensitivity, phase0, hist, *, n_valid=None):
    """Single-stream fused TX (B5), the JAX call's arguments and returns:
    (i (N*I,), q (N*I,), phase').  i and q are views of the kernel's
    complex64 output; see ``gfsk_tx_folded_iq`` for the arguments."""
    iq, phase = gfsk_tx_folded_iq(nrz, taps, interpolation, sensitivity, phase0, hist,
                                  n_valid=n_valid)
    return iq.real, iq.imag, phase


def gfsk_tx_call_folded_plain(nrz, taps, interpolation, sensitivity, phase0, hist, *,
                              n_valid=None):
    """Plain version of ``gfsk_tx_call_folded``."""
    iq, phase = gfsk_tx_folded_iq_plain(nrz, taps, interpolation, sensitivity, phase0, hist,
                                        n_valid=n_valid)
    return iq.real, iq.imag, phase


def gfsk_tx_call_plain(nrz_tm, taps, interpolation, sensitivity, phase0, hist, *, n_valid=None):
    """Plain version of ``gfsk_tx_call``."""
    t2d = _taps2d(taps, interpolation, nrz_tm.device)
    k = t2d.shape[0]
    work = torch.cat([hist.to(torch.float32), nrz_tm.to(torch.float32)])
    iq, ph = _tx_plain(work, t2d, sensitivity, phase0, _n_valid(n_valid, nrz_tm.shape[0]))
    return iq.real, iq.imag, ph, work[work.shape[0] - (k - 1) :].clone()


def gfsk_tx_call(nrz_tm, taps, interpolation, sensitivity, phase0, hist, *, n_valid=None):
    """Fused TX over one block of streams on lanes (B6): nrz_tm (N, L)
    float32 NRZ, time-major; taps (T,) natural order; phase0 (L,) and hist
    (k-1, L) float32 the carried state, on nrz_tm's device.  Returns (i_tm,
    q_tm (N*I, L), phase' (L,) float64, hist' (k-1, L)): hist' is the last
    k-1 rows of [hist | nrz_tm], rows past ``n_valid`` included, as the JAX
    kernel's.  i_tm and q_tm are views of the kernel's complex64 output."""
    global batched_launches
    if _build.device_kind(nrz_tm, "gfsk_tx_call") == "cpu":
        return gfsk_tx_call_plain(nrz_tm, taps, interpolation, sensitivity, phase0, hist,
                                  n_valid=n_valid)
    dev = nrz_tm.device
    t2d = _taps2d(taps, interpolation, dev)
    table = _table(taps, interpolation, sensitivity, dev)
    k, ii = t2d.shape
    n, lanes = nrz_tm.shape
    total = n * ii
    if total == 0 or total >= MAX_SAMPLES:
        raise ValueError(f"tx: {n} rows x {ii} = {total} samples a call, the kernel takes "
                         "0 < samples < 2^30")
    phase0 = torch.as_tensor(phase0, dtype=torch.float64, device=dev).expand(lanes).contiguous()
    _build.check_arg("tx", "nrz_tm", nrz_tm, (n, lanes), torch.float32, dev)
    _build.check_arg("tx", "hist", hist, (k - 1, lanes), torch.float32, dev)
    lib = _build.load("tx", _SIGNATURES)
    out = torch.empty((total, lanes), dtype=torch.complex64, device=dev)
    sums = torch.empty((tx_plan(n, ii, k, lanes).scratch, lanes), dtype=torch.float64, device=dev)
    phase_out = torch.empty(lanes, dtype=torch.float64, device=dev)
    hist_out = torch.empty((k - 1, lanes), dtype=torch.float32, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tx_batched_forward(
            nrz_tm.data_ptr(), n, lanes, hist.data_ptr(), t2d.data_ptr(), _ptr(table), k, ii,
            _sens(sensitivity), _n_valid(n_valid, n), phase0.data_ptr(), sums.data_ptr(),
            sums.shape[0], out.data_ptr(), phase_out.data_ptr(), hist_out.data_ptr(), stream,
            ctypes.byref(launched),
        )
    batched_launches += launched.value
    _build.check(lib, rc, "tx_batched_forward")
    return out.real, out.imag, phase_out, hist_out
