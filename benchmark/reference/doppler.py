"""Doppler rows of a client, as upstream sdr-modem derives them.

Upstream src/dsp/doppler.c:31-220: the satellite is propagated once a
second of stream time, the shift is df = f0 - f0 * (c - range_rate) / c
(plus a constant offset), linearly interpolated between the 1-Hz updates
once a processing buffer, truncated to an integer and turned into a
float32 phase increment 2 pi df / fs with the phase carried in float64.

``DopplerRows.block`` gives one block's piecewise-linear phase rows
(start, length, adj, ph0): sample n of a row has phase ph0 + (n - start)
* adj.  ``tables`` lays several lanes' rows out as the (S, lanes) float32
tables the demod step's NCO reads (starts, ends, adjs, ph0s).
"""

from __future__ import annotations

import numpy as np

from .orbit import constants as oc
from .orbit.observer import Geodetic, calculate_obs
from .orbit.sgp4 import Sgp4
from .orbit.timeutil import julian_date, julian_date_of_epoch
from .orbit.tle import parse_tle

SPEED_OF_LIGHT = 2.99792458e5  # km/s
TWO_PI32 = np.float32(2 * np.pi)


class DopplerRows:
    """One client's Doppler state: an observer, a TLE, a start time and a
    sample rate.  Each ``block`` call advances n samples of stream time."""

    def __init__(self, *, latitude, longitude, altitude_km, sampling_freq, center_freq,
                 tle_lines, start_time_seconds, constant_offset=0):
        tle = parse_tle(tle_lines)
        if tle.deep_space:
            raise ValueError("the reference propagates near-earth orbits only")
        self.model = Sgp4(tle)
        self.jul_epoch = julian_date_of_epoch(tle.epoch)
        self.geo = Geodetic(lat=np.deg2rad(np.float32(latitude)), lon=np.deg2rad(np.float32(longitude)),
                            alt=float(np.float32(altitude_km)))
        self.fs = float(sampling_freq)
        self.f0 = int(center_freq)
        self.offset = int(constant_offset)
        self.jul_start = julian_date(float(start_time_seconds))
        self.interval = int(sampling_freq)
        self.pos = self.interval  # samples since the last 1-Hz update: update first
        self.fd = 0.0
        self.next_fd = 0.0
        self.fd_step = 0.0
        self.jul = 0.0
        self.phase = 0.0
        self.started = False

    def _shift(self) -> float:
        st = self.model.propagate((self.jul - self.jul_epoch) * oc.xmnpda)
        obs = calculate_obs(self.jul, st.pos, st.vel, self.geo)
        return self.f0 - self.f0 * (SPEED_OF_LIGHT - obs.range_rate) / SPEED_OF_LIGHT + self.offset

    def _batches(self, n: int):
        """(start, length, integer Hz) of each constant-frequency batch."""
        done = 0
        while done < n:
            left = n - done
            if self.pos >= self.interval:
                batch = min(self.interval, left)
                self.pos = 0
                if not self.started:
                    self.started = True
                    self.jul = self.jul_start
                    self.fd = self._shift()
                else:
                    self.fd = self.next_fd
                self.jul += self.interval / self.fs / oc.secday
                self.next_fd = self._shift()
                self.fd_step = (self.next_fd - self.fd) / self.interval
            else:
                batch = min(self.interval - self.pos, left)
                self.fd += self.fd_step * batch
            self.pos += batch
            yield done, batch, int(self.fd)
            done += batch

    def block(self, n: int) -> list[tuple[int, int, np.float32, np.float32]]:
        """The next n samples' rows (start, length, adj, ph0)."""
        rows = []
        for start, batch, freq in self._batches(n):
            adj = float(np.float32(TWO_PI32 * np.float32(freq) / np.float32(self.fs)))
            rows.append((start, batch, np.float32(adj), np.float32(np.mod(self.phase, 2 * np.pi))))
            self.phase = np.fmod(self.phase + batch * adj, 2 * np.pi)
        return rows


def max_rows(n: int, sampling_freq: int) -> int:
    """The most rows one n-sample block can have: a row a 1-Hz update
    inside it, and one either side."""
    return n // int(sampling_freq) + 2


def tables(rows_by_lane: list, s_rows: int) -> tuple[np.ndarray, ...]:
    """(starts, ends, adjs, ph0s), each (s_rows, lanes) float32, lane k's
    rows from ``rows_by_lane[k]``; unused rows stay 0 (inactive)."""
    lanes = len(rows_by_lane)
    out = [np.zeros((s_rows, lanes), np.float32) for _ in range(4)]
    for lane, rows in enumerate(rows_by_lane):
        if len(rows) > s_rows:
            raise ValueError(f"lane {lane}: {len(rows)} Doppler rows > {s_rows}")
        for k, (st, ln, adj, ph0) in enumerate(rows):
            out[0][k, lane] = st
            out[1][k, lane] = st + ln
            out[2][k, lane] = adj
            out[3][k, lane] = ph0
    return tuple(out)
