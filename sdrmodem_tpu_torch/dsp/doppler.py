"""SGP4/SDP4-driven Doppler frequency correction.

Behavioural equivalent of reference src/dsp/doppler.c:31-220:

- the satellite is propagated once per second of stream time
  (update_interval = sampling_freq samples); the Doppler shift is
  df = dir * (f0 - f0*(c - range_rate)/c) + constant_offset
- between 1 Hz updates the shift is linearly interpolated *per batch*
  (the reference adds freq_difference_per_sample * batch_len at each
  process() boundary, so the correction trajectory depends on the
  caller's buffer size — replicated here via ``block_size``)
- the shift applied to samples is the int64-truncated accumulated
  difference, fed to a float32-increment NCO with carried phase.

Host side: SGP4 + per-second bookkeeping in float64 (cheap, 1 Hz).
Device side: the actual complex mix.  ``process`` accepts numpy blocks
and returns numpy; phases are produced host-side in float64, which
tracks the reference's float32 phase accumulator to <1e-3 rad over the
golden fixtures.

A copy of ``sdrmodem_tpu/dsp/doppler.py`` (numpy only), with the orbit
imports pointing at the port's own copy of ``orbit/``.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

from sdrmodem_tpu_torch.orbit import constants as oc
from sdrmodem_tpu_torch.orbit.observer import Geodetic, calculate_obs
from sdrmodem_tpu_torch.orbit.sdp4 import Sdp4
from sdrmodem_tpu_torch.orbit.sgp4 import Sgp4
from sdrmodem_tpu_torch.orbit.timeutil import julian_date, julian_date_of_epoch
from sdrmodem_tpu_torch.orbit.tle import Tle, parse_tle

SPEED_OF_LIGHT = 2.99792458e5  # km/s

_TWO_PI32 = np.float32(2 * np.pi)


class Satellite:
    """TLE + the appropriate propagator (SGP4 near-earth / SDP4 deep-space)."""

    def __init__(self, tle_lines):
        self.tle: Tle = tle_lines if isinstance(tle_lines, Tle) else parse_tle(tle_lines)
        self.model = Sdp4(self.tle) if self.tle.deep_space else Sgp4(self.tle)
        self.jul_epoch = julian_date_of_epoch(self.tle.epoch)

    def state_at(self, jul_utc: float):
        tsince = (jul_utc - self.jul_epoch) * oc.xmnpda  # minutes
        return self.model.propagate(tsince)


class Doppler:
    """Streaming Doppler corrector with the reference's exact update cadence."""

    def __init__(
        self,
        latitude: float,
        longitude: float,
        altitude_km: float,
        sampling_freq: int,
        center_freq: int,
        tle_lines,
        constant_offset: int = 0,
        start_time_seconds: int = 0,
    ):
        self.sat = Satellite(tle_lines)
        self.geo = Geodetic(
            lat=np.deg2rad(np.float32(latitude)),
            lon=np.deg2rad(np.float32(longitude)),
            alt=float(np.float32(altitude_km)),
        )
        self.fs = float(sampling_freq)
        self.center_freq = int(center_freq)
        self.constant_offset = int(constant_offset)
        self.jul_start = (
            0.0 if start_time_seconds == 0 else julian_date(float(start_time_seconds))
        )
        self.update_interval = int(sampling_freq)  # recompute every second
        self.current_samples = self.update_interval  # force update on first batch
        self.current_fd = 0.0
        self.next_fd = 0.0
        self.fd_per_sample = 0.0
        self.jul_utc = 0.0
        self.phase = 0.0  # NCO phase, float64 tracking of the f32 accumulator
        # device_segments cadence carry: global stream position and the
        # max_batch it was accumulated under (boundaries are multiples of
        # max_batch from stream START, so a mid-stream cadence change
        # would silently shift every later interpolation point)
        self._cadence_pos = 0
        self._cadence_batch: int | None = None

    def _shift(self, direction: int) -> float:
        st = self.sat.state_at(self.jul_utc)
        obs = calculate_obs(self.jul_utc, st.pos, st.vel, self.geo)
        f0 = self.center_freq
        return (
            direction * (f0 - f0 * (SPEED_OF_LIGHT - obs.range_rate) / SPEED_OF_LIGHT)
            + self.constant_offset
        )

    def _segments(self, n: int, direction: int):
        """Yield (start, length, freq_hz) batches for n samples, advancing state."""
        processed = 0
        while processed < n:
            remaining = n - processed
            if self.current_samples >= self.update_interval:
                batch = min(self.update_interval, remaining)
            else:
                batch = min(self.update_interval - self.current_samples, remaining)

            if self.current_samples >= self.update_interval:
                self.current_samples = 0
                if self.next_fd == 0.0:
                    if self.jul_start == 0.0:
                        self.jul_start = julian_date(
                            _dt.datetime.now(_dt.timezone.utc).replace(microsecond=0)
                        )
                    self.jul_utc = self.jul_start
                    self.current_fd = self._shift(direction)
                else:
                    self.current_fd = self.next_fd
                self.jul_utc += self.update_interval / self.fs / oc.secday
                self.next_fd = self._shift(direction)
                self.fd_per_sample = (self.next_fd - self.current_fd) / self.update_interval
            else:
                self.current_fd += self.fd_per_sample * batch
            self.current_samples += batch
            yield processed, batch, int(self.current_fd)  # int64 truncation
            processed += batch

    def _mix(self, iq: np.ndarray, direction: int) -> np.ndarray:
        """Apply the piecewise-constant NCO multiply with carried phase."""
        n = len(iq)
        phases = np.empty(n, np.float64)
        for start, batch, freq in self._segments(n, direction):
            # the reference NCO's per-sample increment is the float32 value
            # 2*pi*freq/fs (src/dsp/sig_source.c:44)
            adj = float(np.float32(_TWO_PI32 * np.float32(freq) / np.float32(self.fs)))
            idx = np.arange(batch, dtype=np.float64)
            phases[start : start + batch] = self.phase + idx * adj
            self.phase = np.fmod(self.phase + batch * adj, 2 * np.pi)
        ph = np.mod(phases, 2 * np.pi).astype(np.float32)
        lo = (np.cos(ph) + 1j * np.sin(ph)).astype(np.complex64)
        return (np.asarray(iq, np.complex64) * lo).astype(np.complex64)

    def process_rx(self, iq: np.ndarray) -> np.ndarray:
        return self._mix(iq, +1)

    def process_tx(self, iq: np.ndarray) -> np.ndarray:
        return self._mix(iq, -1)

    # ------------------------------------------------------------------
    # device-side application: the host keeps the 1 Hz SGP4 bookkeeping
    # (this method) and the device applies the NCO multiply in-stream
    # (dsp/elementwise.py nco_mix_pair_tm, csrc/nco.cuh), mirroring the reference's
    # split between doppler_calculate_shift and the volk NCO multiply
    # (src/dsp/doppler.c:164-186, src/dsp/sig_source.c:60-75).
    MAX_SEG = 4096  # granule of the device ramp's two-level split: the
    # f32 error of m*adj at m < 4096 is <1e-3 rad (below the goldens'
    # 0.01 tolerance); the k*step coarse term is computed in f64 per row
    # (elementwise.nco_mix_pair_tm), so rows span whole 1 Hz segments

    def device_segments(self, n: int, direction: int, max_batch: int | None = None):
        """Advance one ``n``-sample block of stream time and return the
        piecewise-constant NCO descriptors [(start, length, adj, ph0)]
        for the device: within each row the sample phase is
        ph0 + (i - start) * adj.  State advances exactly like ``_mix``
        (same int64 shift truncation, f32 increment, f64 phase carry),
        so host- and device-applied correction match to f32 rounding.

        The reference interpolates Δf per PROCESSING BUFFER
        (doppler.c:164-175), so its correction depends on the buffer
        size; ``max_batch`` pins the interpolation cadence to at most
        that many samples regardless of the block size — e.g. 2000, the
        buffer the golden fixtures were recorded with — making the
        device correction block-size-invariant (used by the sharded
        paths, whose block = N/D is a partitioning choice, not a
        fidelity choice)."""
        if max_batch is None:
            # keep the stream position advancing so a later cadenced call
            # can detect (and refuse) the mid-stream mode switch below
            self._cadence_pos += n
            return self._device_segments_one(n, direction, 0)
        # cadence boundaries are GLOBAL stream positions (multiples of
        # max_batch from stream start), carried across blocks — a block
        # size that is not a cadence multiple must not shift them, or the
        # correction would depend on the block partitioning again
        if self._cadence_batch is None:
            if self._cadence_pos:
                raise ValueError(
                    "device_segments(max_batch=...) after an uncadenced run: "
                    "the interpolation boundaries would shift mid-stream; "
                    "use one cadence mode per Doppler instance"
                )
            self._cadence_batch = int(max_batch)
        elif self._cadence_batch != int(max_batch):
            raise ValueError(
                f"device_segments max_batch changed mid-stream "
                f"({self._cadence_batch} -> {max_batch}); the carried cadence "
                "position is only valid for the cadence it was built with"
            )
        pos = self._cadence_pos
        rows = []
        off = 0
        while off < n:
            m = min(max_batch - (pos % max_batch), n - off)
            rows.extend(self._device_segments_one(m, direction, off))
            off += m
            pos += m
        self._cadence_pos = pos
        return rows

    def _device_segments_one(self, n: int, direction: int, base: int):
        # one row per piecewise-constant frequency segment; the device
        # ramp evaluates d*adj in a two-level (k*4096 + m) form
        # (elementwise.nco_mix_pair_tm), so long segments need no
        # MAX_SEG sub-splitting — O(rows)/sample mix cost stays at the
        # 1 Hz update count
        rows = []
        for start, batch, freq in self._segments(n, direction):
            adj = float(np.float32(_TWO_PI32 * np.float32(freq) / np.float32(self.fs)))
            ph0 = float(np.mod(self.phase, 2 * np.pi))
            rows.append((base + start, batch, np.float32(adj), np.float32(ph0)))
            self.phase = np.fmod(self.phase + batch * adj, 2 * np.pi)
        return rows

    @classmethod
    def max_rows(cls, n: int, sampling_freq: int, max_batch: int | None = None) -> int:
        """Static bound on device_segments rows for an n-sample block."""
        boundaries = n // int(sampling_freq) + 2  # 1 Hz update splits
        if max_batch is None:
            return boundaries
        return -(-n // int(max_batch)) + boundaries + 1
