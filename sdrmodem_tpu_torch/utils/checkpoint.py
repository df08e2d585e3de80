"""Stream-state checkpoint / resume.

Counterpart of ``sdrmodem_tpu/utils/checkpoint.py``.  The reference has no
checkpointing; a demodulator's whole carried state (FIR histories, the
quad-demod sample, the clock's {omega, mu, last, tail or suffix}) is a
NamedTuple of tensors here, so a snapshot is one npz file, and restoring it
and going on gives the symbols the uninterrupted run gives.

The file format is the JAX package's: the leaves as ``leaf_i`` in field
order, depth first, ``None`` leaves skipped (as ``jax.tree.flatten`` skips
them), and ``__meta__`` holding JSON bytes.  So a JAX snapshot of a state
whose leaves have the port's shapes (a ``DemodStateFull`` at a multiple of
128 lanes, a ragged ``DemodState``) resumes in the port, and the other way
round; where the shapes differ (the JAX state's lanes padded to 128),
``utils/convert.py`` crosses first.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from sdrmodem_tpu_torch.utils.tree import flatten, unflatten


def save_state(state, path: str | pathlib.Path, meta: dict | None = None) -> None:
    """Snapshot a state of tensors (``DemodState``, ``DemodStateFull``, a
    list of per-shard states) to ``path``, with ``meta`` as JSON."""
    arrays = {f"leaf_{i}": t.detach().cpu().numpy() for i, t in enumerate(flatten(state))}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(template, path: str | pathlib.Path):
    """Restore a snapshot into the structure of ``template`` (the same
    pipeline configuration), each leaf on the template leaf's device.
    Returns (state, meta); raises ``ValueError`` where a leaf's shape or
    dtype differs from the template's."""
    with np.load(path) as data:
        restored = []
        for i, want in enumerate(flatten(template)):
            arr = data[f"leaf_{i}"]
            got = torch.from_numpy(arr)
            if tuple(arr.shape) != tuple(want.shape) or got.dtype != want.dtype:
                raise ValueError(
                    f"snapshot leaf {i} mismatch: {arr.shape}/{arr.dtype} vs "
                    f"{tuple(want.shape)}/{want.dtype} — different pipeline configuration?"
                )
            restored.append(got.to(want.device))
        meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}
    return unflatten(template, restored), meta
