"""Faults planted under the timed path, each a wrapper of the step
``step(state, x, dop) -> (state', symbols (C, n_chunks, K) int8, counts
(C, n_chunks))``: the check has to call a run with any of them not
correct.  (The cells run on one card: no exchange between cards to leave
out.)"""

from __future__ import annotations


def stale_state(step):
    """A step that returns the state it was given, unchanged."""

    def f(state, x, *dop):
        return (state, *step(state, x, *dop)[1:])

    return f


def half_batch(step):
    """Half of the lanes left out: their symbols never computed (zeros)."""

    def f(state, x, *dop):
        new, sym, cnt = step(state, x, *dop)
        sym = sym.clone()
        sym[sym.shape[0] // 2 :] = 0
        return new, sym, cnt

    return f


def altered(step):
    """Symbols altered where they are produced: every 16th slot of each
    chunk moved by 64 LSB."""

    def f(state, x, *dop):
        new, sym, cnt = step(state, x, *dop)
        sym = sym.clone()
        v = sym[..., ::16]
        sym[..., ::16] = (v - 64) * (v >= 0) + (v + 64) * (v < 0)
        return new, sym, cnt

    return f


FAULTS = {"stale_state": stale_state, "half_batch": half_batch, "altered": altered}
