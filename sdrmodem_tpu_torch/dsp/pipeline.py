"""The demodulator pipelines: the ragged stream step and the batched
full-block step.

Counterpart of ``sdrmodem_tpu/dsp/pipeline.py``.  Two paths:

- the ragged path (``pipeline.py:45-361, 678-739``): ``DemodStreamer``
  (the server's per-client RX, ``server/session.py:107-110, 186-188``) and
  ``make_batched_step``.  Buffers have static sizes set by ``block``, the
  number of valid samples is a runtime tensor, and every stage carries its
  history in a ``FirRaggedState`` (zeros past ``hist_len``).  Its FIRs are
  ``dsp/fir.py``'s: the float32 path is B3's kernel, ``exact=True`` the
  float64-accumulated one; its clock is B4 (``ops/clock.py:clock_mm_tpu``)
  on the card.  The quad demod is plain PyTorch, as the JAX package's is
  plain XLA.
- the full-block path (``pipeline.py:58-72, 365-381, 383-474,
  569-676``): every channel advances by exactly ``block`` samples a step,
  through an optional per-lane Doppler NCO mix, the front end
  (``ops/front.py``: fused, or banded on B3) and the clock kernel
  (``ops/clock.py``), and every FIR tail, the one-row quad-demod carry and
  the clock's {omega, mu, last, suffix, resid} carry over in
  ``DemodStateFull``.  ``front="step"`` runs the front and the clock as
  one kernel (B7, ``ops/step.py``) on the same state.  Its state is
  time-major with channels along the last axis, unpadded: the JAX package
  pads lanes to a multiple of 128 for the TPU, the port does not
  (``utils/convert.py`` crosses between the two).

JAX's ``dynamic_slice`` and ``dynamic_update_slice`` clamp their starts so
the window fits; each clamp is written out here.  Entry points run on the
CUDA device unless given ``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.clock_recovery import (
    ClockFullState,
    ClockState,
    check_sps_supported,
    clock_mm_batched_full,
    clock_mm_batched_pallas,
    clock_mm_stream,
    initial_full_state,
    initial_state,
    max_symbols,
    suffix_cap_for,
)
from sdrmodem_tpu_torch.dsp.elementwise import (
    atan2_dispatch,
    atan_table,
    conj_product,
    dc_blocker_taps,
    is_lut_mode,
)
from sdrmodem_tpu_torch.dsp.fir import conv1d, conv1d_banded
from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig, float_to_int8
from sdrmodem_tpu_torch.ops._build import resolve_device
from sdrmodem_tpu_torch.ops.clock import default_bank
from sdrmodem_tpu_torch.ops.front import FrontTaps, banded_front, front_tile, fused_front
from sdrmodem_tpu_torch.ops.step import DEFAULT_CHUNK, check_step, fused_step, step_available

LAYOUTS = ("cm", "tm", "fanout")
FRONTS = {"fused": fused_front, "banded": banded_front}


class FirRaggedState(NamedTuple):
    hist: torch.Tensor  # (..., rows, cap) f32, zeros past hist_len
    hist_len: torch.Tensor  # (...) i32


class DemodState(NamedTuple):
    """Carried state of the ragged step; leaves may lead with (C,)."""

    lpf1: FirRaggedState  # I and Q as 2 rows
    quad_prev: torch.Tensor  # (..., 2) f32 — previous (I, Q)
    lpf2: FirRaggedState
    dc: FirRaggedState | None
    clock: ClockState


class DemodStateFull(NamedTuple):
    """Carried state of the full-block step (C = channels)."""

    lpf1_hist: torch.Tensor  # (t1-1, 2C) f32, I lanes then Q lanes
    quad_prev: torch.Tensor  # (1, 2C) f32
    lpf2_hist: torch.Tensor  # (t2-1, C) f32
    dc_hist: torch.Tensor | None  # (4L-4, C) f32, None without a DC blocker
    clock: ClockFullState


def _lanes(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-stream value (...) viewed as (..., 1, ..., 1) against a
    tensor of ``ndim`` dims."""
    return v.reshape(v.shape + (1,) * (ndim - v.dim()))


def _window(work: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """work[..., start:start + size] with a per-stream start, clamped so
    the window fits (``lax.dynamic_slice``)."""
    start = start.clamp(0, work.shape[-1] - size).to(torch.int64)
    idx = _lanes(start, work.dim()) + torch.arange(size, device=work.device)
    return work.gather(-1, idx.expand(*work.shape[:-1], size))


def _left_align(hist: torch.Tensor, hist_len, x: torch.Tensor, cap: int) -> torch.Tensor:
    """[hist[:hist_len], x, ...] into a (..., rows, cap + N) buffer: x
    written over the history from hist_len on (its start clamped to cap, as
    ``dynamic_update_slice`` clamps it).  Positions past hist_len + N keep
    the history buffer's, zeros by the ``_fir_ragged`` invariant; callers
    mask by work_len."""
    n = x.shape[-1]
    w = cap + n
    pos = torch.arange(w, device=x.device)
    hl = _lanes(hist_len.clamp(0, cap).to(torch.int64), x.dim())
    xg = x.gather(-1, (pos - hl).clamp(0, n - 1).expand(*x.shape[:-1], w))
    return torch.where((pos >= hl) & (pos < hl + n), xg, torch.nn.functional.pad(hist, (0, n)))


def _masked(work: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """work with every position at or past ``length`` zeroed."""
    pos = torch.arange(work.shape[-1], device=work.device)
    return torch.where(pos < _lanes(length, work.dim()), work, torch.zeros((), device=work.device))


def _fir_ragged(state: FirRaggedState, x, n_valid, rev_taps, decimation: int, max_out: int,
                exact: bool):
    """One ragged FIR stage over x (..., rows, N), the first n_valid
    columns valid: (state', y (..., rows, <= max_out), n_out (...) i32)."""
    t = rev_taps.numel()
    d = int(decimation)
    cap = state.hist.shape[-1]  # t - 1 + d - 1
    work = _left_align(state.hist, state.hist_len, x, cap)
    work_len = state.hist_len + n_valid
    work = _masked(work, work_len)  # stale values never leak into windows
    n_out = torch.div((work_len - (t - 1) + d - 1).clamp(min=0), d, rounding_mode="floor")
    flat = work.reshape(-1, work.shape[-1])
    if exact:  # the float64-accumulated FIR: the golden-parity path
        y = conv1d(flat, rev_taps, d, 0, exact=True)[:, 0, :max_out]
    else:
        y = conv1d_banded(flat, rev_taps, d, max_out)
    y = y.reshape(*work.shape[:-1], y.shape[-1])
    consumed = n_out * d
    new_hist_len = (work_len - consumed).to(torch.int32)
    new_hist = _masked(_window(work, consumed, cap), new_hist_len)
    return FirRaggedState(new_hist, new_hist_len), y, n_out.to(torch.int32)


def _quad_demod_ragged(prev, x, n_valid, gain, use_lut, table):
    """x: (..., 2, N) pairs.  y[n] = gain * atan2(im, re) of x[n]*conj(x[n-1])."""
    shifted = torch.cat([prev[..., None], x[..., :-1]], dim=-1)
    re, im = conj_product(x[..., 0, :], x[..., 1, :], shifted[..., 0, :], shifted[..., 1, :])
    y = gain * atan2_dispatch(im, re, use_lut, table)
    # previous sample for the next block = last VALID sample of x
    last = _window(x, n_valid - 1, 1)[..., 0]
    new_prev = torch.where(_lanes(n_valid > 0, prev.dim()), last, prev)
    return new_prev, y


class DemodPipeline:
    """GMSK demodulator on one device: the ragged per-stream step
    (``streamer``, ``make_batched_step``) and the batched full-block step
    (``make_batched_step_full``).

    ``use_atan_lut``: True, "lut" or "free" select the reference LUT
    arctangent ("free" is the TPU's gather-free evaluation of the same
    table); False or "atan2" atan2 with the table's (0, 0) -> 0 rule
    (``torch.atan2`` on the ragged path, the banded front's quad-demod
    kernel with ``atan2f`` on the full-block path).
    ``exact=True`` takes the ragged path's FIRs with a float64 accumulator.
    ``device`` defaults to CUDA; pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels."""

    def __init__(self, config: FskDemodConfig, block_size: int, *, use_atan_lut=True,
                 exact: bool = False, device=None):
        is_lut_mode(use_atan_lut)  # raises for a mode the port does not take
        self.config = config
        self.block = int(block_size)
        self.use_atan_lut = use_atan_lut
        self.exact = exact
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
        d = config.decimation
        self.max_mid = self.block  # lpf1 output bound
        self.max_dec = (self.block + d - 1) // d + 1

        def rev(t):
            return torch.from_numpy(t[::-1].copy()).to(self.device)

        self.front_taps = FrontTaps(
            rev1=rev(self._t1),
            rev2=rev(self._t2),
            rev_dc=rev(self._tdc) if self._tdc is not None else None,
            d=d,
            quad_gain=config.quad_gain,
            atan_table=atan_table(self.device),
            atan_lut=is_lut_mode(use_atan_lut),
        )
        self.bank = default_bank(self.device)

    # ------------------------------------------------------------------
    # the ragged path
    def init_state(self, channels: int | None = None) -> DemodState:
        """A fresh ragged state; with ``channels`` every leaf leads with
        (channels,), the state ``make_batched_step`` takes."""
        dev = self.device
        d = self.config.decimation

        def fir(rows, cap, hist_len):
            return FirRaggedState(
                torch.zeros((rows, cap), dtype=torch.float32, device=dev),
                torch.tensor(hist_len, dtype=torch.int32, device=dev),
            )

        state = DemodState(
            lpf1=fir(2, len(self._t1) - 1, len(self._t1) - 1),
            quad_prev=torch.zeros(2, dtype=torch.float32, device=dev),
            lpf2=fir(1, len(self._t2) - 1 + d - 1, len(self._t2) - 1),
            dc=fir(1, len(self._tdc) - 1, len(self._tdc) - 1) if self._tdc is not None else None,
            clock=initial_state(self._clockp["omega"], self._clockp["mu"], device=dev),
        )
        if channels is None:
            return state

        def lead(v):
            if v is None:
                return None
            if isinstance(v, tuple):
                return type(v)(*(lead(f) for f in v))
            return v.expand(int(channels), *v.shape).clone()

        return lead(state)

    def _stage_firs(self, state: DemodState, x_pair, n_valid):
        """LPF1, quad demod and LPF2: ((lpf1', quad_prev', lpf2'), y2, n2)."""
        cfg = self.config
        taps = self.front_taps
        lpf1_state, y1, n1 = _fir_ragged(
            state.lpf1, x_pair, n_valid, taps.rev1, 1, self.max_mid, self.exact
        )
        quad_prev, yq = _quad_demod_ragged(
            state.quad_prev, y1, n1, cfg.quad_gain, self.use_atan_lut, taps.atan_table
        )
        lpf2_state, y2, n2 = _fir_ragged(
            state.lpf2, yq[..., None, :], n1, taps.rev2, cfg.decimation, self.max_dec, self.exact
        )
        return (lpf1_state, quad_prev, lpf2_state), y2, n2

    def _front_impl(self, state: DemodState, x_pair, n_valid):
        """Filter front-end only (everything before clock recovery), for
        one stream or, with leaves led by (C,), every channel of a batch.
        The DC blocker is the (4L-3)-tap FIR."""
        (lpf1, quad_prev, lpf2), y2, n2 = self._stage_firs(state, x_pair, n_valid)
        if self._tdc is not None:
            dc_state, y3, n3 = _fir_ragged(
                state.dc, y2, n2, self.front_taps.rev_dc, 1, self.max_dec, self.exact
            )
        else:
            dc_state, y3, n3 = state.dc, y2, n2
        return (lpf1, quad_prev, lpf2, dc_state), y3[..., 0, :], n3

    def _clock_kw(self):
        p = self._clockp
        return dict(
            omega=p["omega"], gain_omega=p["gain_omega"], mu=p["mu"], gain_mu=p["gain_mu"],
            omega_relative_limit=p["omega_relative_limit"],
        )

    def _step_impl(self, state: DemodState, x_pair, n_valid):
        """One block of one stream: x_pair (2, block) f32, n_valid () i32.
        Returns (state', symbols int8 (K,), count () i32)."""
        front, y3, n3 = self._front_impl(state, x_pair, n_valid)
        outs, count, clock_state = clock_mm_stream(
            y3, state=state.clock, n_valid=n3, **self._clock_kw()
        )
        return DemodState(*front, clock_state), float_to_int8(outs), count

    def _front_batched(self, state: DemodState, x, n_valid):
        """Channel-batched float32 front-end: the FIRs over every channel's
        rows in one launch each, and the DC blocker as cascaded moving
        averages (``_dc_cumsum_stage``)."""
        (lpf1, quad_prev, lpf2), y2, n2 = self._stage_firs(state, x, n_valid)
        if self._tdc is not None:
            dc_state, y3, n3 = self._dc_cumsum_stage(state.dc, y2[:, 0:1, :], n2)
        else:
            dc_state, y3, n3 = state.dc, y2, n2
        return (lpf1, quad_prev, lpf2, dc_state), y3[:, 0, :], n3

    def _dc_cumsum_stage(self, dc_state: FirRaggedState, x, n_valid):
        """The DC blocker as cascaded moving averages, out[t] = work[t -
        2(L-1)] - MA_L^4(work)[t], over the raw-input work buffer (the
        carried 4L-4 samples give every nested average its lookback).  The
        running sums are taken in float64 and each average rounded once to
        float32, so the CPU and the card, whose cumsums add in other orders,
        agree; the JAX package sums in float32."""
        ll = self.config.dc_length
        cap = dc_state.hist.shape[-1]  # 4L - 4
        t_delay = 2 * (ll - 1)
        work = _left_align(dc_state.hist, dc_state.hist_len, x, cap)
        work_len = dc_state.hist_len + n_valid
        work = _masked(work, work_len)
        w = work.shape[-1]
        flat = work[:, 0, :]  # (C, W)
        inv = float(np.float32(1.0 / ll))

        def ma(v):
            s = torch.cumsum(v.double(), dim=-1)
            shifted = torch.cat([s.new_zeros((v.shape[0], ll)), s[:, :-ll]], dim=-1)
            return ((s - shifted) * inv).float()

        m = ma(ma(ma(ma(flat))))
        # output k is work position k + cap; the count of a (4L-3)-tap FIR
        n_out = (work_len - cap).clamp(min=0)
        delayed = flat[:, cap - t_delay : w - t_delay][:, : self.max_dec]
        ma4 = m[:, cap:w][:, : self.max_dec]
        pad = self.max_dec - delayed.shape[-1]
        if pad > 0:
            delayed = torch.nn.functional.pad(delayed, (0, pad))
            ma4 = torch.nn.functional.pad(ma4, (0, pad))
        y = (delayed - ma4)[:, None, :]
        new_hist_len = (work_len - n_out).to(torch.int32)
        new_hist = _masked(_window(work, n_out, cap), new_hist_len)
        return FirRaggedState(new_hist, new_hist_len), y, n_out.to(torch.int32)

    def make_batched_step(self, clock_backend: str = "scan"):
        """Batched ragged step: (state, x (C, 2, B) f32, n_valid (C,) i32)
        -> (state', symbols int8 (C, K), counts (C,) i32), the state's
        leaves led by C (``init_state(channels=C)``).  ``clock_backend``
        "pallas" runs every channel's clock in one B4 launch
        (``clock_mm_batched_pallas``), "scan" through ``clock_mm_stream``
        (B4 too on the card, its plain version on the CPU).  Without
        ``exact`` the front is ``_front_batched``; with it, the streamer's
        ``_front_impl`` over every channel."""
        if clock_backend not in ("scan", "pallas"):
            raise ValueError(f"unknown clock_backend {clock_backend!r}")
        clock = clock_mm_batched_pallas if clock_backend == "pallas" else None

        def step(state: DemodState, x: torch.Tensor, n_valid: torch.Tensor):
            if not self.exact:
                front, y3, n3 = self._front_batched(state, x, n_valid)
            else:
                front, y3, n3 = self._front_impl(state, x, n_valid)
            if clock is not None:
                outs, counts, clock_state = clock(y3, n3, state.clock, **self._clock_kw())
            else:
                outs, counts, clock_state = clock_mm_stream(
                    y3, state=state.clock, n_valid=n3, **self._clock_kw()
                )
            return DemodState(*front, clock_state), float_to_int8(outs), counts

        return step

    def streamer(self) -> "DemodStreamer":
        return DemodStreamer(self)

    # ------------------------------------------------------------------
    # the full-block path
    def _check_full_block(self) -> None:
        if self.block % self.config.decimation != 0:
            raise ValueError("the full-block step requires block % decimation == 0")

    def init_full_state(self, channels: int) -> DemodStateFull:
        self._check_full_block()
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
            # contiguous: at one channel the reshape is a strided view
            return x.permute(2, 1, 0).reshape(b, 2 * c).contiguous()
        if layout == "fanout":
            # one shared IQ stream broadcast to every lane
            return torch.cat(
                [x[0][:, None].expand(b, c), x[1][:, None].expand(b, c)], dim=1
            )
        return x.contiguous()

    def fused_front_available(self) -> bool:
        """Whether the fused front (B1) takes this pipeline: the float32
        path with the LUT arctangent, and taps whose histories and tile fit
        one block's shared memory (``ops/front.py:front_tile``).  Where
        not, ``make_batched_step_full(front="fused")`` takes the banded
        front, as the JAX package does where B1 has no tile.  It answers on
        any device."""
        if self.exact or not is_lut_mode(self.use_atan_lut):
            return False
        return front_tile(len(self._t1), len(self._t2), self.config.decimation) is not None

    def fused_step_available(self, channels: int, chunk: int = DEFAULT_CHUNK) -> bool:
        """Whether ``front="step"`` runs B7 on this block: the float32 path
        with the LUT arctangent, whole clock chunks, ``block % (d * chunk)
        == 0``, a chunk that holds the carried suffix, and a layout within
        one block's shared memory (``ops/step.py:step_plan``).  Any number
        of channels: the JAX kernel's one 128-lane register of channels is
        the TPU's, not the port's.  It answers on any device, from the
        shapes alone."""
        if self.exact or not is_lut_mode(self.use_atan_lut) or int(channels) < 1:
            return False
        t3 = len(self._tdc) if self._tdc is not None else 0
        return step_available(self.block, len(self._t1), len(self._t2), t3, self.config.decimation,
                              chunk, suffix_cap_for(self._clockp["omega"]))

    def _step_fused_impl(self, state: DemodStateFull, x_tm, dop, chunk: int = DEFAULT_CHUNK):
        """One block through the fused front+clock kernel (``ops/step.py``):
        (state', outs (C, n_chunks, K) f32, counts (C, n_chunks) i32), the
        bits of ``fused_front`` followed by ``clock_mm_batched_full`` with
        the symbols in chunks of ``chunk`` rows."""
        p = self._clockp
        ck = state.clock
        omega_mid = float(np.float32(p["omega"]))
        num_symbols = max_symbols(
            chunk + ck.suffix.shape[0], omega_mid, p["omega_relative_limit"], p["gain_mu"]
        )
        sym, counts, _, front, clock = fused_step(
            x_tm, *state[:4], ck.suffix, ck.omega, ck.mu, ck.last_sample, ck.resid,
            self.front_taps, self.bank, chunk=chunk, num_symbols=num_symbols, omega_mid=omega_mid,
            omega_relative_limit=p["omega_relative_limit"], gain_omega=p["gain_omega"],
            gain_mu=p["gain_mu"], dop=dop,
        )
        new_clock = ClockFullState(
            clock["omega"], clock["mu"], clock["last"], clock["suffix"], clock["resid"], ck.overflow
        )
        return DemodStateFull(*front, new_clock), sym.permute(2, 0, 1), counts.T

    def make_batched_step_full(
        self, clock_backend: str = "pallas", *, doppler: bool = False, layout: str = "cm",
        front: str = "fused", chunk: int = DEFAULT_CHUNK,
    ):
        """Batched full-block step: (state, x) -> (state', symbols int8
        (C, n_chunks, K), counts int32 (C, n_chunks)); with ``doppler=True``
        (state, x, dop) -> the same.  The JAX signature, so the server's
        ``make_batched_step_full("pallas", doppler=True, layout="fanout")``
        (``sdrmodem_tpu/server/session.py:388-390``) runs as written.

        ``clock_backend`` is "pallas", the chunked clock kernel (B2) over
        the whole block, or "scan", the chunks one at a time through the
        ragged walk (B4 on the card, its plain version on the CPU); the two
        give the same bits.  ``exact`` raises ``ValueError``, as the JAX
        package's float32-only path does.

        ``layout`` picks the input convention (C = the state's channels):
          - "cm"     x is (C, 2, B), channel-major;
          - "tm"     x is (B, 2C), time-major, I in lanes [0, C) and Q in
                     [C, 2C): the kernels' own layout, no re-layout;
          - "fanout" x is (2, B): one shared IQ stream broadcast to every
                     lane (the reference's sdr_worker fan-out); per-lane
                     Doppler still sets the lanes apart.

        ``front`` is "fused" (``ops/front.py:fused_front``, B1 from one C
        call, the default), "banded" (``banded_front``: the same kernels one
        at a time, its FIRs through B3) or "step" (``ops/step.py:
        fused_step``, B7: the front and the clock in one kernel, y3 kept on
        the chip, the clock in chunks of ``chunk`` decimated rows).  All
        three give the same symbol stream, bit for bit, at the same chunk;
        "step" splits it into chunks of ``chunk`` rows where the others take
        ``clock_chunk(C)``, which moves symbols between rows without
        changing them unless a stride runs back past a chunk's first row
        (each chunk reads only its own rows) or a chunk's K slots fill.
        As in the JAX package, "step" with ``clock_backend="scan"`` runs
        "fused" (the step's clock is the chunked kernel), and so does
        "step" where ``fused_step_available(1, chunk)`` is False: a block
        that is not whole chunks, or filters whose layout passes one
        block's shared memory.  A ``chunk`` that B2 cannot take (not a
        multiple of 8, or shorter than the carried suffix) raises
        ``ValueError``.  These are arguments, and no environment variable
        is read.  "fused" takes the
        banded front where ``fused_front_available()`` is False: filters
        too long for B1's shared-memory layout (LPF1 past ~690 taps, e.g.
        288 kHz at 9600 Bd), as the JAX package takes it where B1 has no
        TPU tile, and for the atan2 arctangent modes (``use_atan_lut`` False
        or "atan2"), which B1 and B7 do not take: there every front runs
        ``banded_front``, its quad-demod kernel with ``atan2f``.  Each
        choice is made here, once, from the shapes; the launch counters
        show which route ran (``ops/step.py:launches``,
        ``ops/front.py:fused_launches``, ``ops/clock.py:launches``), and
        every route gives the same bits.

        With ``doppler=True`` the step takes ``dop = (starts, ends, adjs,
        ph0s)``, each an (S, C) float32 tensor on the pipeline's device with
        S >= 1 (rows of ``Doppler.device_segments``), and mixes each lane by
        its rows before LPF1.  Lanes with no active row pass through bit
        for bit.
        """
        if self.exact:
            raise ValueError("the full-block fast path is float32-only")
        self._check_full_block()
        if clock_backend not in ("pallas", "scan"):
            raise ValueError(f"unknown clock_backend {clock_backend!r}")
        if front == "step" and clock_backend != "pallas":
            front = "fused"  # the fused step is the chunked clock kernel
        if front == "step":
            check_step(chunk, suffix_cap_for(self._clockp["omega"]))
            if not self.fused_step_available(1, chunk):
                front = "fused"  # B7 does not take this block: the JAX package's route
        elif front not in FRONTS:
            raise ValueError(f"unknown front {front!r}")
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}")
        p = self._clockp
        front_fn = FRONTS.get(front)
        if front == "fused" and not self.fused_front_available():
            front_fn = banded_front

        def step(state: DemodStateFull, x: torch.Tensor, dop=None):
            c = state.quad_prev.shape[1] // 2
            x_tm = self.to_time_major(x, c, layout)
            if front == "step":
                new_state, outs, counts = self._step_fused_impl(state, x_tm, dop, chunk)
                return new_state, float_to_int8(outs), counts
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
                backend=clock_backend,
            )
            return DemodStateFull(*fstate, clock), float_to_int8(outs), counts

        if doppler:
            return step
        return lambda state, x: step(state, x)


class DemodStreamer:
    """One stream through the ragged step, block by block, with its state."""

    def __init__(self, pipeline: DemodPipeline):
        self.p = pipeline
        self.state = pipeline.init_state()

    def process(self, iq: np.ndarray) -> np.ndarray:
        """complex64 IQ of ANY length -> int8 symbols (numpy); the last
        chunk is zero-padded to the block and passed with its true length."""
        iq = np.asarray(iq, np.complex64)
        block, dev = self.p.block, self.p.device
        out = []
        for start in range(0, len(iq), block):
            chunk = iq[start : start + block]
            buf = np.zeros((2, block), np.float32)
            buf[0, : len(chunk)] = chunk.real
            buf[1, : len(chunk)] = chunk.imag
            n_valid = torch.tensor(len(chunk), dtype=torch.int32, device=dev)
            self.state, symbols, count = self.p._step_impl(
                self.state, torch.from_numpy(buf).to(dev), n_valid
            )
            c = int(count)
            if c:
                out.append(symbols[:c].cpu().numpy())
        return np.concatenate(out) if out else np.zeros(0, np.int8)
