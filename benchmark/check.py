"""How ``correct`` is decided: the reference over the window's sampled
blocks, and the gap between its symbols and the program's.

The clock makes the state a long history: a block's symbols depend on
every block before it, and the reference cannot walk a whole window of
clients in the time of a run.  So the check follows the program from its
own state.  It compares, for the lanes drawn from the seed:

- the first two blocks from the reference's own fresh state (the start);
- blocks k drawn from the window, each from the program's state before it,
  and after each the first ``carry_chunks`` clock chunks of block k+1 from
  the state the reference carried out of block k, so that the carry
  between blocks is checked too.  (The front and the clock are causal: the
  first chunks' symbols do not depend on the rows after them.)

Each lane-block's symbols are compared position by position; a symbol
that one side has and the other does not counts as off.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.fsk import BF16, F32, Clock, ClockState, Front, FrontState, Precision, Radio


class Segment(NamedTuple):
    """Two consecutive blocks of the sampled lanes: the shared IQ stream of
    each ((2, B) float32), the lanes' Doppler tables for each (four (S, L)
    float32) or None, and the state before the first (``ref_state`` of the
    program's state) or None for the fresh state.  The check compares all
    of the first block and the first chunks of the second."""

    x: list
    dop: list
    state: tuple | None


def ref_state(state, lanes) -> tuple:
    """The program's full-block state (``lpf1_hist``, ``quad_prev``,
    ``lpf2_hist``, ``dc_hist``, ``clock``) for ``lanes``, as numpy: what
    the reference starts a sampled block from."""
    idx = torch.as_tensor(np.asarray(lanes), device=state.quad_prev.device)
    c = state.quad_prev.shape[1] // 2

    def iq(t):
        return torch.cat([t[:, idx], t[:, c + idx]], dim=1).cpu().numpy()

    def ln(t):
        return None if t is None else t[..., idx].cpu().numpy()

    ck = state.clock
    return (iq(state.lpf1_hist), iq(state.quad_prev), ln(state.lpf2_hist), ln(state.dc_hist),
            ln(ck.omega), ln(ck.mu), ln(ck.last_sample), ln(ck.suffix), ln(ck.resid).astype(np.int64))


def _join(states: list[tuple], front: Front, clock: Clock, lanes: int):
    """The segments' start states side by side, lanes of segment 0 first."""
    fresh_f = front.init_state(lanes)
    fresh_c = clock.init_state(lanes)
    parts = []
    for st in states:
        if st is None:
            st = (fresh_f.lpf1.cpu().numpy(), fresh_f.quad.cpu().numpy(), fresh_f.lpf2.cpu().numpy(),
                  None if fresh_f.dc is None else fresh_f.dc.cpu().numpy(), *fresh_c)
        parts.append(st)

    def cat_iq(k):
        return np.concatenate([p[k][:, :lanes] for p in parts] + [p[k][:, lanes:] for p in parts], axis=1)

    def cat(k):
        return None if parts[0][k] is None else np.concatenate([p[k] for p in parts], axis=-1)

    dev = front.device
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    fs = FrontState(t(cat_iq(0)), t(cat_iq(1)), t(cat(2)), t(cat(3)))
    cs = ClockState(*(cat(k) for k in range(4, 8)), cat(8))
    return fs, cs


def reference(radio: Radio, step_lanes: int, block: int, segments: list[Segment], lanes: int,
              device, carry_chunks: int, prec: Precision = F32) -> list[list[list[np.ndarray]]]:
    """The reference's symbols: [segment][block of the pair][lane] int8
    arrays (the second block's first ``carry_chunks`` chunks), every
    segment's lanes walked side by side."""
    if not segments:
        return []
    front = Front(radio, device, prec)
    clock = Clock(radio, step_lanes, block // radio.decimation, prec)
    fs, cs = _join([s.state for s in segments], front, clock, lanes)
    out = [[None, None] for _ in segments]
    n_seg = len(segments)
    for b in range(2):
        rows = block if b == 0 else min(block, carry_chunks * clock.chunk * radio.decimation)
        xs = [torch.from_numpy(np.ascontiguousarray(s.x[b][:, :rows])).to(front.device) for s in segments]
        i = torch.cat([x[0][:, None].expand(rows, lanes) for x in xs], dim=1)
        q = torch.cat([x[1][:, None].expand(rows, lanes) for x in xs], dim=1)
        x_tm = torch.cat([i, q], dim=1).contiguous()
        dop = None
        if segments[0].dop[b] is not None:
            dop = tuple(torch.from_numpy(np.concatenate([s.dop[b][k] for s in segments], axis=1)).to(front.device)
                        for k in range(4))
        y3, fs = front.block(x_tm, fs, dop)
        syms, _, cs = clock.block(y3.cpu().numpy(), cs, None if b == 0 else carry_chunks)
        del y3, x_tm
        for s in range(n_seg):
            out[s][b] = syms[s * lanes : (s + 1) * lanes]
    return out


def program_symbols(sym: np.ndarray, counts: np.ndarray) -> list[np.ndarray]:
    """Each lane's valid symbols of one step's (C, n_chunks, K) int8 slots
    and (C, n_chunks) counts, in order."""
    return [np.concatenate([sym[c, t, : counts[c, t]] for t in range(counts.shape[1])])
            for c in range(sym.shape[0])]


def gaps(prog: list[np.ndarray], ref: list[np.ndarray]) -> dict:
    """The numbers of the comparison over lane-blocks: ``off2_share``, the
    share of symbol positions more than 2 LSB apart (the upstream goldens'
    tolerance) or present on one side only; ``count_gap``, the largest
    difference in a lane-block's symbol count; ``max_lsb``, the widest gap
    where both have a symbol; ``blocks_off``, the share of lane-blocks with
    any position off; ``apart``, for the first lane-blocks that differ at
    all, [index, positions that differ, the first, the widest gap]."""
    if not prog:
        return {"symbols": 0}  # nothing compared: no reading, which fails the check
    off = total = 0
    count_gap = max_lsb = blocks = 0
    where = []
    for i, (p, r) in enumerate(zip(prog, ref, strict=True)):
        m, n = max(len(p), len(r)), min(len(p), len(r))
        d = np.abs(p[:n].astype(np.int64) - r[:n].astype(np.int64))
        o = int((d > 2).sum()) + (m - n)
        off += o
        total += m
        blocks += o > 0
        count_gap = max(count_gap, m - n)
        max_lsb = max(max_lsb, int(d.max()) if n else 0)
        if d.any() and len(where) < 8:  # lane-block, positions apart, first, widest
            nz = np.flatnonzero(d)
            where.append([i, int(nz.size), int(nz[0]), int(d.max())])
    return {"off2_share": off / max(total, 1), "count_gap": count_gap, "max_lsb": max_lsb,
            "blocks_off": blocks / max(len(prog), 1), "symbols": total, "apart": where}


def compare(radio: Radio, step_lanes: int, block: int, segments: list[Segment], prog: list, lanes: int,
            device, carry_chunks: int, control: bool = False) -> dict:
    """``gaps`` of the program's symbols (``prog``: [segment][block][lane])
    against the reference's, the second block's as far as the reference's
    first chunks reach; with
    ``control``, also under ``"control"`` the gaps of the reference in
    bfloat16 put in the program's place."""
    t = time.perf_counter()
    ref = reference(radio, step_lanes, block, segments, lanes, device, carry_chunks)
    ref_s = time.perf_counter() - t

    def flat(pairs, like=None):
        out = []
        for i, (a, b) in enumerate(pairs):
            out += list(a) + (list(b) if like is None else [x[: len(y)] for x, y in zip(b, like[i][1])])
        return out

    numbers = gaps(flat(prog, ref), flat(ref))
    if control:
        low = reference(radio, step_lanes, block, segments, lanes, device, carry_chunks, BF16)
        numbers["control"] = gaps(flat(low), flat(ref))
    numbers["compared_blocks"] = len(segments)
    numbers["reference_s"] = ref_s
    return numbers
