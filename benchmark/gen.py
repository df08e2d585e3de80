"""The traffic generator: every input of a run, made from ``--seed``.

One generator for every mix; a mix is a data file of parameters
(``traffic/<mix>.json``) and a configuration the radio it is sent at
(``configs/<config>.json``).

- The stream: the configuration's recorded capture (``data/``) tiled from
  an offset drawn from the seed, with complex white noise at the mix's
  ``snr_db`` added, cut into ``ring`` blocks of ``block`` samples.  Every
  seed gets the same sizes; only the offset and the noise differ.
- The clients: each lane's pass over the configuration's ground station,
  starting at a second drawn from the seed within ``pass_spread_s`` of the
  pass's start, at the configuration's centre frequency.
- The step mixes also take each lane's Doppler rows for the ring's blocks
  from the reference's own SGP4 (``reference/doppler.py``), once a block,
  as the server's group advances them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from benchmark.reference.doppler import DopplerRows, max_rows, tables

HERE = Path(__file__).resolve().parent


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one named stream of draws of ``seed``."""
    return np.random.default_rng([int(seed) % 2**32, int(seed) // 2**32 % 2**32, *stream])


def stream_blocks(cfg: dict, mix: dict, seed: int) -> np.ndarray:
    """(ring, block) complex64: the capture tiled from a seeded offset,
    plus noise at ``snr_db`` below the capture's power."""
    cap = np.fromfile(HERE / cfg["capture"], np.complex64)
    n = int(mix["ring"]) * int(mix["block"])
    g = rng(seed, 1)
    idx = (int(g.integers(0, len(cap))) + np.arange(n)) % len(cap)
    power = float(np.mean(np.abs(cap) ** 2))
    sigma = np.sqrt(power * 10 ** (-float(mix["snr_db"]) / 10) / 2)
    noise = g.standard_normal((2, n), dtype=np.float32) * np.float32(sigma)
    x = cap[idx] + (noise[0] + 1j * noise[1]).astype(np.complex64)
    return x.astype(np.complex64).reshape(int(mix["ring"]), int(mix["block"]))


def client_starts(cfg: dict, mix: dict, seed: int) -> np.ndarray:
    """Each lane's pass start, unix seconds."""
    g = rng(seed, 2)
    spread = int(mix["pass_spread_s"])
    return int(cfg["pass"]["start_time_seconds"]) + g.integers(0, spread + 1, int(mix["lanes"]))


def client_doppler(cfg: dict, start: int) -> DopplerRows:
    """One client's Doppler rows over the configuration's pass."""
    p = cfg["pass"]
    return DopplerRows(
        latitude=p["latitude"], longitude=p["longitude"], altitude_km=p["altitude_km"],
        sampling_freq=cfg["radio"]["sampling_freq"], center_freq=p["center_freq"],
        tle_lines=p["tle"], start_time_seconds=int(start))


def doppler_ring(cfg: dict, mix: dict, starts: np.ndarray) -> list[tuple[np.ndarray, ...]]:
    """For each block of the ring, the (S, lanes) float32 tables of every
    lane's rows, each lane's corrector advanced a block at a time."""
    block, fs = int(mix["block"]), int(cfg["radio"]["sampling_freq"])
    s_rows = max_rows(block, fs)
    dops = [client_doppler(cfg, s) for s in starts]
    return [tables([d.block(block) for d in dops], s_rows) for _ in range(int(mix["ring"]))]


def sample_lanes(lanes: int, count: int, seed: int) -> np.ndarray:
    """The lanes the correctness check reads, sorted."""
    return np.sort(rng(seed, 3).choice(lanes, size=min(count, lanes), replace=False))


class Reservoir:
    """A uniform sample of ``size`` items from a stream of unknown length
    (Algorithm R), its draws from the seed: the steps or blocks of the
    window the check compares.  ``offer(i)`` returns the slot item i takes
    and the item it evicts (None, None when it is not kept)."""

    def __init__(self, size: int, seed: int):
        self.size = int(size)
        self.g = rng(seed, 4)
        self.items: list[int] = []
        self.seen = 0

    def offer(self, item: int):
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return len(self.items) - 1, None
        j = int(self.g.integers(0, self.seen))
        if j < self.size:
            old, self.items[j] = self.items[j], item
            return j, old
        return None, None
