"""Carry demodulator states between the JAX package and the port.

- ``state_from_numpy`` / ``state_to_numpy``: the ragged ``DemodState`` of
  the streamer and ``make_batched_step``, one stream or leaves led by C.
  Both packages keep the same leaves in the same layout, so the crossing
  is a copy; the clock's tail capacity is ``tail_cap_for(omega)`` on both
  sides.
- ``full_state_from_numpy`` / ``full_state_to_numpy``: the full-block
  ``DemodStateFull``.  The JAX state and Doppler tables pad their lanes to
  a multiple of 128 (I lanes in [0, Cp), Q lanes in [Cp, 2Cp)); the port
  keeps exactly C lanes.
- ``sharded_state_to_numpy`` / ``sharded_state_from_numpy``: the
  per-shard states of ``parallel/channels.py``'s classes against the JAX
  classes' one global state.

These functions take and give numpy arrays in the JAX layout, so neither
side needs the other's framework.  Like the pipeline, they put tensors on
the CUDA device unless given ``device="cpu"``, and raise where there is no
card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.clock_recovery import ClockFullState, ClockState
from sdrmodem_tpu_torch.dsp.pipeline import DemodState, DemodStateFull, FirRaggedState
from sdrmodem_tpu_torch.ops._build import resolve_device

LANES = 128  # the JAX package's lane multiple


class NumpyClockFullState(NamedTuple):
    omega: np.ndarray
    mu: np.ndarray
    last_sample: np.ndarray
    suffix: np.ndarray
    resid: np.ndarray
    overflow: np.ndarray


class NumpyDemodStateFull(NamedTuple):
    lpf1_hist: np.ndarray
    quad_prev: np.ndarray
    lpf2_hist: np.ndarray
    dc_hist: np.ndarray | None
    clock: NumpyClockFullState


def _iq_lanes(a: np.ndarray, channels: int) -> np.ndarray:
    """(rows, 2Cp) I|Q lanes -> (rows, 2C)."""
    cp = a.shape[1] // 2
    return np.concatenate([a[:, :channels], a[:, cp : cp + channels]], axis=1)


def state_from_numpy(state, device=None) -> DemodState:
    """A ragged ``DemodState`` with numpy leaves (the JAX streamer's state,
    or a batched one with leaves led by C) as the port's, on ``device``
    (default CUDA)."""
    device = resolve_device(device)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    def fir(f):
        return None if f is None else FirRaggedState(t(f.hist), t(f.hist_len, torch.int32))

    ck = state.clock
    return DemodState(
        lpf1=fir(state.lpf1),
        quad_prev=t(state.quad_prev),
        lpf2=fir(state.lpf2),
        dc=fir(state.dc),
        clock=ClockState(
            t(ck.omega), t(ck.mu), t(ck.last_sample), t(ck.tail), t(ck.tail_len, torch.int32)
        ),
    )


def state_to_numpy(state: DemodState):
    """The port's ragged state as the same tree with numpy leaves."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return type(state)(*(state_to_numpy(v) for v in state))
    return state.detach().cpu().numpy()


def full_state_from_numpy(state, channels: int, device=None) -> DemodStateFull:
    """A JAX ``DemodStateFull`` (numpy leaves, lanes padded) as the port's
    state for its first ``channels`` lanes, on ``device`` (default CUDA)."""
    c = int(channels)
    device = resolve_device(device)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    ck = state.clock
    return DemodStateFull(
        lpf1_hist=t(_iq_lanes(np.asarray(state.lpf1_hist), c)),
        quad_prev=t(_iq_lanes(np.asarray(state.quad_prev), c)),
        lpf2_hist=t(np.asarray(state.lpf2_hist)[:, :c]),
        dc_hist=None if state.dc_hist is None else t(np.asarray(state.dc_hist)[:, :c]),
        clock=ClockFullState(
            omega=t(np.asarray(ck.omega)[:c]),
            mu=t(np.asarray(ck.mu)[:c]),
            last_sample=t(np.asarray(ck.last_sample)[:c]),
            suffix=t(np.asarray(ck.suffix)[:, :c]),
            resid=t(np.asarray(ck.resid)[:c], torch.int32),
            overflow=t(np.asarray(ck.overflow)[:c]),
        ),
    )


def segment_tables(rows_by_lane: dict, s_rows: int, lanes: int):
    """The server's Doppler tables (``sdrmodem_tpu/server/session.py:522-536``):
    (starts, ends, adjs, ph0s), each (s_rows, lanes) float32 numpy, from
    ``Doppler.device_segments`` rows per lane; lanes without rows stay zero
    (no active row)."""
    tables = [np.zeros((s_rows, lanes), np.float32) for _ in range(4)]
    for lane, rows in rows_by_lane.items():
        if len(rows) > s_rows:
            raise ValueError(f"lane {lane}: {len(rows)} Doppler rows > {s_rows}")
        for k, (st, ln, adj, ph0) in enumerate(rows):
            tables[0][k, lane] = st
            tables[1][k, lane] = st + ln
            tables[2][k, lane] = adj
            tables[3][k, lane] = ph0
    return tuple(tables)


def doppler_tables_from_numpy(tables, channels: int, device=None):
    """JAX-layout Doppler tables ((starts, ends, adjs, ph0s), each (S, Cp)
    with lanes padded) as the port's ``dop``: four contiguous (S, C)
    float32 tensors on ``device`` (default CUDA)."""
    device = resolve_device(device)
    c = int(channels)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(np.asarray(t, np.float32)[:, :c])).to(device)
        for t in tables
    )


def full_state_to_numpy(state: DemodStateFull) -> NumpyDemodStateFull:
    """The port's state in the JAX layout, lanes padded to a multiple of 128.

    Padded lanes of the FIR tails and the suffix are zero; the per-lane
    clock values of the padded lanes repeat the last real lane, so they
    hold a valid clock state."""
    c = state.quad_prev.shape[1] // 2
    pad = -(-c // LANES) * LANES - c

    def a(x):
        return x.detach().cpu().numpy()

    def lanes(x):  # (rows, C) -> (rows, Cp)
        return np.pad(a(x), ((0, 0), (0, pad)))

    def iq(x):  # (rows, 2C) -> (rows, 2Cp)
        x = a(x)
        return np.concatenate(
            [np.pad(x[:, :c], ((0, 0), (0, pad))), np.pad(x[:, c:], ((0, 0), (0, pad)))],
            axis=1,
        )

    def vec(x):  # (C,) -> (Cp,)
        return np.pad(a(x), (0, pad), mode="edge")

    ck = state.clock
    return NumpyDemodStateFull(
        lpf1_hist=iq(state.lpf1_hist),
        quad_prev=iq(state.quad_prev),
        lpf2_hist=lanes(state.lpf2_hist),
        dc_hist=None if state.dc_hist is None else lanes(state.dc_hist),
        clock=NumpyClockFullState(
            omega=vec(ck.omega),
            mu=vec(ck.mu),
            last_sample=vec(ck.last_sample),
            suffix=lanes(ck.suffix),
            resid=vec(ck.resid),
            overflow=np.pad(a(ck.overflow), (0, pad)),
        ),
    )


def _zip_map(fn, trees):
    """fn over the matching leaves of numpy trees of one structure (None
    kept), as the first tree's types."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        parts = [_zip_map(fn, [t[i] for t in trees]) for i in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") else type(first)(parts)
    return fn([np.asarray(t) for t in trees])


def sharded_state_to_numpy(states: list):
    """A sharded class's per-shard states (``parallel/channels.py``) as the
    JAX class's global state, numpy leaves: ``DemodStateFull`` leaves
    channel-last, each shard's lanes padded to a multiple of 128 (the JAX
    class's per-shard ``init_full_state``) and the shards side by side;
    ragged ``DemodState`` leaves led by the global channels."""
    if isinstance(states[0], DemodStateFull):
        return _zip_map(lambda a: np.concatenate(a, axis=-1), [full_state_to_numpy(s) for s in states])
    return _zip_map(lambda a: np.concatenate(a, axis=0), [state_to_numpy(s) for s in states])


def sharded_state_from_numpy(state, devices: list, channels: int) -> list:
    """The JAX sharded class's global state (numpy leaves) as the port's
    per-shard states, one on each of ``devices``, for ``channels`` channels
    in all (equal runs a shard)."""
    n = len(devices)
    if channels % n:
        raise ValueError(f"{channels} channels do not divide over {n} shards")
    if hasattr(state, "lpf1_hist"):  # full-block: split the last axis
        parts = [_zip_map(lambda a, i=i: np.split(a[0], n, axis=-1)[i], [state]) for i in range(n)]
        return [full_state_from_numpy(p, channels // n, device=d) for p, d in zip(parts, devices)]
    parts = [_zip_map(lambda a, i=i: np.split(a[0], n, axis=0)[i], [state]) for i in range(n)]
    return [state_from_numpy(p, device=d) for p, d in zip(parts, devices)]
