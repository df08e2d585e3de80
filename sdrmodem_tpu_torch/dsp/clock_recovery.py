"""Mueller & Müller symbol-timing recovery.

Counterpart of ``sdrmodem_tpu/dsp/clock_recovery.py``: the ragged stream
clock (``clock_mm_stream``, ``clock_mm_batched_pallas``, ``ClockState``)
and the full-block clock (``clock_mm_batched_full``, ``ClockFullState``).
Reference: src/dsp/clock_recovery_mm.c:78-139 plus the 8-tap MMSE
fractional-delay interpolator (src/dsp/mmse_fir_interpolator.c:188-191):

    y_k     = dot(x[ii .. ii+7], bank[rint(mu * 128)])
    mm      = sgn(last) * y_k - sgn(y_k) * last
    omega  <- omega_mid + clip(omega + g_o * mm - omega_mid, +-lim)
    mu     <- mu + omega + g_m * mm;   ii += floor(mu);   mu -= floor(mu)

(NaN input emits 0.0 and strides floor(omega), reference :107-113.)

The ragged state carries the unconsumed input tail and its length; a
negative ``tail_len`` is the exact overshoot of the last stride into the
next block.  The full-block state carries the last ``suffix`` input samples
verbatim plus ``resid``, the number of them not yet consumed; the next
block prepends the suffix and starts its read pointer at ``suffix -
resid``.

Every walk is ``ops/clock.py``'s: on a CUDA tensor the B4 kernel
(``clock_mm_tpu``) or, for ``backend="pallas"`` of the full-block clock,
B2 (``clock_mm_chunked``); on a CPU tensor their plain versions.
``_mm_scan_core`` is B4's plain walk under the JAX package's signature
(one lane or many, scalars broadcast); nothing here dispatches through it.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp import taps as taps_mod
from sdrmodem_tpu_torch.ops._build import resolve_device
from sdrmodem_tpu_torch.ops.clock import (
    clock_mm_chunked,
    clock_mm_tpu,
    default_bank,
    mm_walk_plain,
)

NTAPS = taps_mod.MMSE_INTERP_NTAPS  # 8
NSTEPS = taps_mod.MMSE_INTERP_NSTEPS  # 128

# Floor of the ragged clock's tail capacity (covers sps <= ~22); the
# capacity is derived from omega (tail_cap_for), always a multiple of 8.
TAIL_CAP = 32


def tail_cap_for(omega: float, omega_relative_limit: float = 0.01) -> int:
    """Tail capacity (multiple of 8) provably >= the largest unconsumed
    tail for this omega: NTAPS + ceil(omega*(1+limit)) + 2."""
    need = NTAPS + int(np.ceil(float(omega) * (1.0 + omega_relative_limit))) + 2
    return max(TAIL_CAP, -(-need // 8) * 8)

# Floor of the carried suffix (covers sps <= ~53); the capacity is derived
# from omega (suffix_cap_for), always a multiple of 8.
SUFFIX = 64

# Largest supported samples-per-symbol, the JAX package's contract bound.
MAX_SPS = 512.0


def suffix_cap_for(omega: float, omega_relative_limit: float = 0.01) -> int:
    """Suffix capacity (multiple of 8) provably >= the largest unconsumed
    tail for this omega: NTAPS + ceil(omega*(1+limit)) + 2."""
    need = NTAPS + int(np.ceil(float(omega) * (1.0 + omega_relative_limit))) + 2
    return max(SUFFIX, -(-need // 8) * 8)


def check_sps_supported(omega: float) -> None:
    if float(omega) > MAX_SPS:
        raise ValueError(
            f"samples-per-symbol {float(omega):.1f} exceeds the supported "
            f"bound {MAX_SPS:.0f}; increase demod_decimation so "
            f"Fs/baud/decimation <= {MAX_SPS:.0f}"
        )


class ClockState(NamedTuple):
    """State of the ragged clock; leaves may lead with batch dims."""

    omega: torch.Tensor  # () f32
    mu: torch.Tensor  # () f32
    last_sample: torch.Tensor  # () f32
    tail: torch.Tensor  # (cap,) f32 — unconsumed input samples, zeros past tail_len
    tail_len: torch.Tensor  # () i32 — < 0: skip that many samples of the next block


def initial_state(omega: float, mu: float = 0.5, *, device=None) -> ClockState:
    """A fresh ragged clock state on ``device`` (CUDA by default)."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    return ClockState(
        omega=torch.tensor(omega, **f32),
        mu=torch.tensor(mu, **f32),
        last_sample=torch.tensor(0.0, **f32),
        tail=torch.zeros(tail_cap_for(omega), **f32),
        tail_len=torch.tensor(0, dtype=torch.int32, device=device),
    )


class ClockFullState(NamedTuple):
    """State of the full-block clock path (lanes last, unpadded)."""

    omega: torch.Tensor  # (C,) f32
    mu: torch.Tensor  # (C,) f32
    last_sample: torch.Tensor  # (C,) f32
    suffix: torch.Tensor  # (sfx, C) f32 — last sfx input samples
    resid: torch.Tensor  # (C,) i32 — unconsumed count (< sfx)
    overflow: torch.Tensor  # (C,) f32 — always 0: the port has no window ladder


def initial_full_state(
    omega: float, channels: int, mu: float = 0.5, *, device
) -> ClockFullState:
    f32 = dict(dtype=torch.float32, device=device)
    return ClockFullState(
        omega=torch.full((channels,), omega, **f32),
        mu=torch.full((channels,), mu, **f32),
        last_sample=torch.zeros((channels,), **f32),
        suffix=torch.zeros((suffix_cap_for(omega), channels), **f32),
        resid=torch.zeros((channels,), dtype=torch.int32, device=device),
        overflow=torch.zeros((channels,), **f32),
    )


def mm_params(sps: float) -> dict:
    """The reference fsk_demod's M&M constants (src/dsp/fsk_demod.c:63-67)."""
    sps = np.float32(sps)
    return dict(
        omega=float(sps),
        gain_omega=float(np.float32(sps * np.float32(np.pi)) / np.float32(100.0)),
        mu=0.5,
        gain_mu=0.0625,
        omega_relative_limit=0.01,
    )


def max_symbols(n_in: int, omega_mid: float, omega_relative_limit: float, gain_mu: float) -> int:
    """Static upper bound on symbols produced from n_in input samples."""
    min_stride = max(1.0, np.floor(omega_mid * (1.0 - omega_relative_limit) - 4.0 * gain_mu))
    return int(np.ceil(n_in / min_stride)) + 2


def clock_chunk(lanes: int = 128) -> int:
    """Samples per clock chunk: the JAX package's partition (2048 rows at up
    to 128 lanes, halved for each further 128 lanes), so the port's
    (C, n_chunks, K) output splits symbols exactly as the JAX step does.
    ``SDRM_CLOCK_CHUNK`` overrides it, read on each call."""
    raw = os.environ.get("SDRM_CLOCK_CHUNK")
    if raw is None:
        lane_tiles = max(1, -(-int(lanes) // 128))
        val = max(SUFFIX, 2048 * 128 // (lane_tiles * 128) // 8 * 8)
    else:
        val = int(raw)
    if val % 8 != 0 or val < SUFFIX:
        raise ValueError(
            f"SDRM_CLOCK_CHUNK={val}: must be a multiple of 8 and >= {SUFFIX} "
            "(the carried suffix must fit one chunk)"
        )
    return val


def chunk_plan(
    n: int,
    c: int,
    sfx: int,
    *,
    omega: float,
    gain_omega: float,
    gain_mu: float = 0.0625,
    omega_relative_limit: float = 0.01,
    num_symbols: int | None = None,
    mu: float | None = None,  # accepted so a clock_params() dict can be passed whole
) -> dict:
    """The keyword arguments of ``ops.clock`` for an (n, c) block: the
    chunk, the symbol slots K of every chunk (sized by the largest, so the
    chunks stack) and the step's float32 constants."""
    chunk = max(clock_chunk(c), sfx)
    omega_mid = float(np.float32(omega))
    if num_symbols is None:
        num_symbols = max_symbols(min(chunk, n) + sfx, omega_mid, omega_relative_limit, gain_mu)
    return dict(
        chunk=chunk,
        num_symbols=int(num_symbols),
        omega_mid=omega_mid,
        omega_lim=float(np.float32(np.float32(omega_mid) * np.float32(omega_relative_limit))),
        gain_omega=float(np.float32(gain_omega)),
        gain_mu=float(np.float32(gain_mu)),
    )


def _mm_scan_core(
    work: torch.Tensor,  # (..., L) f32
    base_valid,  # (...) i32
    ii0,  # (...) i32 — initial read pointer
    mu0,
    omega0,
    last0,
    *,
    omega_mid,
    omega_lim,
    gain_omega,
    gain_mu,
    num_symbols: int,
    bank: torch.Tensor | None = None,
):
    """The sequential M&M loop (reference src/dsp/clock_recovery_mm.c:78-139)
    as at most ``num_symbols`` masked steps, every lane of the leading dims
    at once: the plain walk of ``ops/clock.py:mm_walk_plain``.  Returns
    ((ii, mu, omega, last, count), outs (..., num_symbols))."""
    lead = work.shape[:-1]
    flat = work.reshape(-1, work.shape[-1])
    c = flat.shape[0]

    def lanes(v, dtype):
        return torch.as_tensor(v, dtype=dtype, device=work.device).expand(lead).reshape(c)

    f32 = torch.float32
    outs, count, (omega, mu, last, ii) = mm_walk_plain(
        flat, lanes(base_valid, torch.int32), lanes(ii0, torch.int32),
        lanes(omega0, f32), lanes(mu0, f32), lanes(last0, f32),
        default_bank(work.device) if bank is None else bank,
        num_symbols=num_symbols, omega_mid=float(np.float32(omega_mid)), omega_lim=float(omega_lim),
        gain_omega=float(np.float32(gain_omega)), gain_mu=float(np.float32(gain_mu)),
    )
    outs = torch.cat([outs, outs.new_zeros((c, int(num_symbols) - outs.shape[1]))], dim=1)
    carry = (ii.to(torch.int32), mu, omega, last, count)
    return tuple(v.reshape(lead) for v in carry), outs.reshape(*lead, int(num_symbols))


def _clock_params(omega, gain_omega, gain_mu, omega_relative_limit):
    """The keyword arguments of ``ops/clock.py:clock_mm_tpu``."""
    return dict(
        omega_mid=float(np.float32(omega)), omega_relative_limit=omega_relative_limit,
        gain_omega=gain_omega, gain_mu=gain_mu,
    )


def _ragged_work(x, n_valid, state: ClockState):
    """[tail[:tail_len], x, 0...] (C, n + 2cap) for x (C, n), masked past
    each lane's valid length, and (base_valid, ii0); a negative tail_len
    is a skip of -tail_len samples into x (``clock_recovery.py:581-592``)."""
    c, n = x.shape
    cap = state.tail.shape[-1]
    w = n + 2 * cap
    pos = torch.arange(w, device=x.device)
    tl = state.tail_len.clamp(min=0)[:, None]
    xg = x.gather(1, (pos - tl).clamp(0, n - 1).expand(c, w))
    tail = torch.nn.functional.pad(state.tail, (0, w - cap))
    work = torch.where((pos >= tl) & (pos < tl + n), xg, tail)
    base_valid = (tl[:, 0] + n_valid).to(torch.int32)
    work = torch.where(pos < base_valid[:, None], work, torch.zeros((), device=x.device))
    ii0 = (-state.tail_len).clamp(min=0).to(torch.int32)
    return work, base_valid, ii0


def _tail_handoff(work, base_valid, ii, cap):
    """The next state's (tail, tail_len): work[ii:base_valid], or a
    negative tail_len when the last stride overshot the valid end
    (``clock_recovery.py:245-257``); JAX's clamped slice start written out."""
    w = work.shape[-1]
    ii = ii.to(torch.int64)
    tail_len = torch.minimum(base_valid - ii, torch.full_like(ii, cap))
    start = torch.minimum(ii, base_valid.to(torch.int64)).clamp(0, w - cap)
    idx = start[:, None] + torch.arange(cap, device=work.device)
    tail = work.gather(1, idx)
    tail = torch.where(
        torch.arange(cap, device=work.device) < tail_len.clamp(min=0)[:, None], tail,
        torch.zeros((), device=work.device),
    )
    return tail, tail_len.to(torch.int32)


def _clock_ragged(x, n_valid, state: ClockState, *, omega, gain_omega, gain_mu,
                  omega_relative_limit, num_symbols):
    """The stream clock over x (C, n) with per-lane n_valid and state, one
    call of ``clock_mm_tpu`` (B4 on a CUDA tensor, its plain version on a
    CPU tensor).  Returns (outs (C, K), counts (C,), state') with
    K = ``k_slots(num_symbols)``."""
    cap = state.tail.shape[-1]
    work, base_valid, ii0 = _ragged_work(x.to(torch.float32), n_valid, state)
    outs, counts, fin = clock_mm_tpu(
        work, base_valid, state.omega, state.mu, state.last_sample, ii0,
        num_symbols=num_symbols, **_clock_params(omega, gain_omega, gain_mu, omega_relative_limit),
    )
    tail, tail_len = _tail_handoff(work, base_valid, fin["ii"], cap)
    return outs, counts, ClockState(fin["omega"], fin["mu"], fin["last"], tail, tail_len)


def clock_mm_stream(
    x: torch.Tensor,
    *,
    omega: float,
    gain_omega: float,
    mu: float = 0.5,
    gain_mu: float = 0.0625,
    omega_relative_limit: float = 0.01,
    state: ClockState | None = None,
    n_valid=None,
    num_symbols: int | None = None,
):
    """M&M clock recovery over a float32 stream x (L,), or over every row
    of x (..., L) with state leaves led by the same dims.

    ``state`` carries {omega, mu, last, tail} across blocks (the tail is
    prepended to x); ``n_valid`` marks how many samples of x are
    meaningful.  Returns (symbols (..., K) f32, count (...) i32, state')
    with K the static ``num_symbols`` bound and only the first ``count``
    entries valid.  On a CUDA tensor the walk is the B4 kernel; on a CPU
    tensor its plain version."""
    lead, ln = x.shape[:-1], x.shape[-1]
    if state is None:
        st = initial_state(omega, mu, device=x.device)
        state = ClockState(*(v.expand(tuple(lead) + v.shape) for v in st))
    cap = state.tail.shape[-1]
    if num_symbols is None:
        num_symbols = max_symbols(ln + cap, float(np.float32(omega)), omega_relative_limit, gain_mu)
    nv = torch.as_tensor(ln if n_valid is None else n_valid, dtype=torch.int32, device=x.device)
    c = int(np.prod(lead, dtype=np.int64))
    # contiguous: a fresh state's leaves are expanded views, and B4 reads
    # each through its pointer
    flat = ClockState(*(v.reshape(c, *v.shape[len(lead):]).contiguous() for v in state))
    outs, counts, new = _clock_ragged(
        x.reshape(c, ln), nv.expand(lead).reshape(c), flat,
        omega=omega, gain_omega=gain_omega, gain_mu=gain_mu,
        omega_relative_limit=omega_relative_limit, num_symbols=int(num_symbols),
    )
    new = ClockState(*(v.reshape(tuple(lead) + v.shape[1:]) for v in new))
    return outs[:, : int(num_symbols)].reshape(*lead, int(num_symbols)), counts.reshape(lead), new


def clock_mm_batched_pallas(
    x: torch.Tensor,  # (C, N) float32
    n_valid: torch.Tensor,  # (C,) int32
    state: ClockState,  # batched: leaves with leading (C,)
    *,
    omega: float,
    gain_omega: float,
    mu: float = 0.5,
    gain_mu: float = 0.0625,
    omega_relative_limit: float = 0.01,
    num_symbols: int | None = None,
):
    """Every channel in one call of the B4 kernel (its plain version on a
    CPU tensor), with ``clock_mm_stream``'s stream semantics and state
    hand-off.  Returns (outs (C, K) f32 with K = ``k_slots(num_symbols)``,
    counts (C,) i32, state').  The JAX kernel's overflow re-run has no
    counterpart: the port's kernel never overflows."""
    c, n = x.shape
    cap = state.tail.shape[-1]
    if num_symbols is None:
        num_symbols = max_symbols(n + cap, float(np.float32(omega)), omega_relative_limit, gain_mu)
    return _clock_ragged(
        x, n_valid, state, omega=omega, gain_omega=gain_omega, gain_mu=gain_mu,
        omega_relative_limit=omega_relative_limit, num_symbols=int(num_symbols),
    )


def _clock_full_one(
    x_tm: torch.Tensor,  # (cs, C)
    state: ClockFullState,
    *,
    bank,
    omega,
    gain_omega,
    gain_mu,
    omega_relative_limit,
    num_symbols,
):
    """One chunk of the full-block clock through the ragged walk: work =
    [suffix | chunk], every lane valid to its end, from sfx - resid: one
    ``clock_mm_tpu`` call, time-major (B4 on a CUDA tensor).  ``overflow`` stays 0: the port's kernel has no window to
    overflow, so JAX's re-run on the full window is one call here."""
    n, c = x_tm.shape
    sfx = state.suffix.shape[0]
    work = torch.cat([state.suffix, x_tm.to(torch.float32)], dim=0)  # (w, C)
    w = n + sfx
    base_valid = torch.full((c,), w, dtype=torch.int32, device=x_tm.device)
    ii0 = (sfx - state.resid).to(torch.int32)
    outs, counts, fin = clock_mm_tpu(
        work, base_valid, state.omega, state.mu, state.last_sample, ii0,
        num_symbols=num_symbols, time_major=True, bank=bank,
        **_clock_params(omega, gain_omega, gain_mu, omega_relative_limit),
    )
    outs = outs[:, :num_symbols]
    ii, mu_f, omega_f, last_f = fin["ii"], fin["mu"], fin["omega"], fin["last"]
    # a negative resid is the last stride's overshoot past the chunk's end
    resid = torch.clamp(w - ii.to(torch.int32), max=sfx - 1).to(torch.int32)
    new_state = ClockFullState(omega_f, mu_f, last_f, work[w - sfx :], resid, state.overflow)
    return outs, counts, new_state


def clock_mm_batched_full(
    y3: torch.Tensor,  # (N, C) float32, time-major
    state: ClockFullState,
    *,
    bank: torch.Tensor,  # (129, 8) MMSE bank on y3's device
    omega: float,
    gain_omega: float,
    mu: float = 0.5,
    gain_mu: float = 0.0625,
    omega_relative_limit: float = 0.01,
    num_symbols: int | None = None,
    backend: str = "pallas",
):
    """Batched M&M over one full block, in chunks of ``clock_chunk(C)``.

    ``backend`` "pallas" runs B2 over the whole block in one launch;
    "scan" runs the chunks one at a time through ``_clock_full_one`` (B4 a
    chunk on the card).  The two give the same bits.

    Returns (outs (C, n_chunks, K) f32, counts (C, n_chunks) i32, state').
    """
    if backend not in ("pallas", "scan"):
        raise ValueError(f"unknown clock backend {backend!r}")
    n, c = y3.shape
    sfx = state.suffix.shape[0]
    plan = chunk_plan(
        n, c, sfx, omega=omega, gain_omega=gain_omega, gain_mu=gain_mu,
        omega_relative_limit=omega_relative_limit, num_symbols=num_symbols,
    )
    if backend == "scan":
        chunk, k = plan["chunk"], plan["num_symbols"]
        outs_all, counts_all = [], []
        for s in range(0, max(n, 1), chunk):
            o, cnt, state = _clock_full_one(
                y3[s : s + chunk], state, bank=bank, omega=omega, gain_omega=gain_omega,
                gain_mu=gain_mu, omega_relative_limit=omega_relative_limit, num_symbols=k,
            )
            outs_all.append(o)
            counts_all.append(cnt)
        return torch.stack(outs_all, dim=1), torch.stack(counts_all, dim=1), state
    outs, counts, fin = clock_mm_chunked(
        y3, state.suffix, state.omega, state.mu, state.last_sample, state.resid, bank, **plan
    )
    if n >= sfx:
        suffix = y3[n - sfx :]
    else:
        suffix = torch.cat([state.suffix, y3], dim=0)[-sfx:]
    new_state = ClockFullState(
        fin[0], fin[1], fin[2], suffix.contiguous(), fin[3], state.overflow
    )
    return outs.permute(2, 0, 1), counts.T, new_state
