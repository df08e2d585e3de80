"""The plain reference of the fast group's demod step: a client's IQ block
through the Doppler NCO, LPF1, the quadrature demod, LPF2 (decimating), the
DC blocker and the Mueller & Mueller clock to int8 soft symbols.

It follows upstream sdr-modem's chain (src/dsp/fsk_demod.c:28-110,
src/dsp/lpf_taps.c, src/math/fast_atan2f.c, src/dsp/dc_blocker.c,
src/dsp/clock_recovery_mm.c, src/dsp/mmse_fir_interpolator.c) in the
batched step's float32 arithmetic, lanes side by side:

- every FIR sums its taps in order, each tap one multiply-add rounded once
  to float32 (taken in float64, where a float32 product is exact);
- the DC blocker is its (4L-3)-tap FIR: four length-L moving averages
  taken from a 2(L-1) delay line;
- the NCO's phase is a two-level ramp (k * 4096 + m) from each row's start;
- the clock walks the block in chunks, each chunk reading only the rows of
  its own work buffer [the carried suffix | the chunk], K masked steps a
  chunk, as the step partitions its symbols.

The front runs in PyTorch on any device (float32, or bfloat16 for the
control, ``Precision``); the clock in NumPy on the host.  Nothing here is
taken from the program: the taps, tables, bank and initial state are worked
out here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

NTAPS = 8  # the MMSE interpolator's taps
NSTEPS = 128  # its phases
SUFFIX = 64  # the least carried clock suffix


# ---- filter and table design (upstream src/dsp/lpf_taps.c:33-103)


def lowpass(gain: float, fs: float, cutoff: float, transition: float) -> np.ndarray:
    """Windowed-sinc low-pass taps, Hamming window, unit DC gain, float32
    at upstream's rounding points."""
    ntaps = int(53.0 * float(fs) / (22.0 * float(transition)))
    ntaps += 1 - ntaps % 2
    n = np.arange(ntaps, dtype=np.float64)
    w = (0.54 - 0.46 * np.cos(2.0 * np.pi * n / (ntaps - 1))).astype(np.float32).astype(np.float64)
    m = (ntaps - 1) // 2
    wc = 2.0 * np.pi * float(cutoff) / float(fs)
    k = np.arange(-m, m + 1, dtype=np.float64)
    taps = np.empty(ntaps, np.float64)
    taps[m] = wc / np.pi * w[m]
    nz = k != 0
    taps[nz] = np.sin(k[nz] * wc) / (k[nz] * np.pi) * w[nz]
    taps = taps.astype(np.float32)
    total = np.float32(taps[m])
    for i in range(1, m + 1):
        total = np.float32(total + np.float32(2.0) * taps[i + m])
    return (taps * (np.float32(gain) / total)).astype(np.float32)


def dc_taps(length: int) -> np.ndarray:
    """The DC blocker x[t - 2(L-1)] - MA_L^4(x)[t] as one causal FIR."""
    u = np.full(length, 1.0 / length)
    k = -np.convolve(np.convolve(u, u), np.convolve(u, u))
    k[2 * (length - 1)] += 1.0
    return k.astype(np.float32)


def atan_table() -> np.ndarray:
    """atan(i / 255), i = 0..255, the last entry repeated."""
    i = np.arange(257, dtype=np.float64)
    i[256] = 255.0
    return np.arctan(i / 255.0).astype(np.float32)


def mmse_bank() -> np.ndarray:
    """(129, 8) least-squares fractional-delay interpolators over the band
    |f| < 1/4 (the classic table), at the table's six printed digits."""
    j = np.arange(8, dtype=np.float64)
    a = np.sinc(0.5 * (j[:, None] - j[None, :]))
    rows = np.array([np.linalg.solve(a, np.sinc(0.5 * (j - 3.0 - i / 128.0))) for i in range(129)])
    rows[np.abs(rows) < 1e-9] = 0.0
    out = np.zeros_like(rows)
    for idx, v in np.ndenumerate(rows):
        if v != 0.0:
            out[idx] = round(float(v), 5 - int(math.floor(math.log10(abs(v)))))
    return out.astype(np.float32)


# ---- the configuration's derived constants (fsk_demod.c:28-110)


@dataclass(frozen=True)
class Radio:
    fs: int
    baud: int
    deviation: int
    decimation: int
    transition: int
    dc_block: bool

    @classmethod
    def from_config(cls, cfg: dict) -> "Radio":
        r = cfg["radio"]
        return cls(int(r["sampling_freq"]), int(r["baud_rate"]), int(r["deviation"]),
                   int(r["decimation"]), int(r["transition_width"]), bool(r["use_dc_block"]))

    @property
    def sps(self) -> float:
        return float(np.float32(self.fs / self.baud / self.decimation))

    def lpf1(self) -> np.ndarray:
        carson = float(abs(self.deviation)) + float(self.baud) / 2.0
        return lowpass(1.0, self.fs, int(carson), int(np.float32(0.1) * np.float32(carson)))

    def lpf2(self) -> np.ndarray:
        return lowpass(1.0, self.fs, self.baud // 2, self.transition)

    def dc(self) -> np.ndarray | None:
        return dc_taps(int(np.ceil(np.float32(self.sps) * 32))) if self.dc_block else None

    @property
    def quad_gain(self) -> float:
        return float(np.float32(self.fs / (2.0 * np.pi * float(self.deviation))))

    def clock(self) -> dict:
        sps = np.float32(self.sps)
        omega = float(sps)
        lim = 0.01
        return dict(
            omega_mid=omega,
            omega_lim=float(np.float32(np.float32(omega) * np.float32(lim))),
            gain_omega=float(np.float32(np.float32(sps * np.float32(np.pi)) / np.float32(100.0))),
            gain_mu=0.0625,
            mu=0.5,
            lim=lim,
        )

    @property
    def suffix(self) -> int:
        """Rows of y3 the clock carries: the interpolator's window and the
        longest stride, in multiples of 8."""
        need = NTAPS + int(np.ceil(self.sps * 1.01)) + 2
        return max(SUFFIX, -(-need // 8) * 8)

    def chunk(self, lanes: int) -> int:
        """The step's clock chunk: 2048 rows up to 128 lanes, halved for
        each further 128 (at least the suffix)."""
        tiles = max(1, -(-int(lanes) // 128))
        return max(SUFFIX, 2048 * 128 // (tiles * 128) // 8 * 8, self.suffix)

    def steps_per_chunk(self, lanes: int, block_rows: int) -> int:
        """K, the clock's masked steps a chunk: the most symbols
        [suffix | chunk] can hold at the shortest stride."""
        p = self.clock()
        n_in = min(self.chunk(lanes), block_rows) + self.suffix
        stride = max(1.0, np.floor(p["omega_mid"] * (1.0 - p["lim"]) - 4.0 * p["gain_mu"]))
        return int(np.ceil(n_in / stride)) + 2


# ---- precision: float32 (the reference) or bfloat16 (the control)


class Precision(NamedTuple):
    name: str

    def t(self, x: torch.Tensor) -> torch.Tensor:
        """A float32 tensor rounded to this precision (kept as float32)."""
        return x if self.name == "float32" else x.bfloat16().float()

    def n(self, x: np.ndarray) -> np.ndarray:
        """A float32 array rounded to this precision, nearest even."""
        if self.name == "float32":
            return x
        x = np.asarray(x, np.float32)
        u = x.view(np.uint32)
        r = (u + (((u >> 16) & 1) + np.uint32(0x7FFF))) & np.uint32(0xFFFF0000)
        return np.where(np.isnan(x), x, r.view(np.float32))


F32 = Precision("float32")
BF16 = Precision("bfloat16")


# ---- the front: NCO -> LPF1 -> quad demod -> LPF2 -> DC, time-major


class FrontState(NamedTuple):
    lpf1: torch.Tensor  # (t1 - 1, 2L): I lanes, then Q lanes
    quad: torch.Tensor  # (1, 2L)
    lpf2: torch.Tensor  # (t2 - 1, L)
    dc: torch.Tensor | None  # (t3 - 1, L)


class Front:
    """The front's taps and table on ``device``, in ``prec``."""

    def __init__(self, radio: Radio, device, prec: Precision = F32):
        self.radio = radio
        self.prec = prec
        self.device = torch.device(device)
        self.taps1 = [float(v) for v in prec.n(radio.lpf1())[::-1]]
        self.taps2 = [float(v) for v in prec.n(radio.lpf2())[::-1]]
        dc = radio.dc()
        self.taps3 = None if dc is None else [float(v) for v in prec.n(dc)[::-1]]
        self.table = torch.from_numpy(atan_table()).to(self.device)
        self.gain = radio.quad_gain

    def init_state(self, lanes: int) -> FrontState:
        z = dict(dtype=torch.float32, device=self.device)
        return FrontState(
            torch.zeros((len(self.taps1) - 1, 2 * lanes), **z), torch.zeros((1, 2 * lanes), **z),
            torch.zeros((len(self.taps2) - 1, lanes), **z),
            None if self.taps3 is None else torch.zeros((len(self.taps3) - 1, lanes), **z))

    def fir(self, x: torch.Tensor, taps: list, stride: int, n_out: int) -> torch.Tensor:
        span = (n_out - 1) * stride + 1
        work = self.prec.t(x).double()
        acc = torch.zeros((n_out, x.shape[1]), dtype=torch.float32, device=x.device)
        for j, tap in enumerate(taps):
            acc = self.prec.t(torch.add(acc, work[j : j + span : stride], alpha=tap).float())
        return acc

    def nco(self, x: torch.Tensor, dop) -> torch.Tensor:
        """Each lane rotated by the phase of the row that covers a sample
        (none: phase 0, a pass-through)."""
        starts, ends, adjs, ph0s = dop
        b, c = x.shape[0], x.shape[1] // 2
        steps = torch.remainder(adjs.double() * 4096.0, 2 * np.pi).float()
        nrow = torch.arange(b, dtype=torch.float32, device=x.device)[:, None]
        ph = torch.zeros((b, c), dtype=torch.float32, device=x.device)
        for s in range(starts.shape[0]):
            dd = nrow - starts[s]
            kq = torch.floor(dd * (1.0 / 4096.0))
            mq = dd - kq * 4096.0
            ramp = (ph0s[s] + mq * adjs[s]) + kq * steps[s]
            ph = ph + torch.where((nrow >= starts[s]) & (nrow < ends[s]), ramp, 0.0)
        p = self.prec.t
        cs, sn = p(torch.cos(ph)), p(torch.sin(ph))
        i, q = p(x[:, :c]), p(x[:, c:])
        return torch.cat([p(p(i * cs) - p(q * sn)), p(p(i * sn) + p(q * cs))], dim=1)

    def atan2(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Upstream's table arctangent (fast_atan2f.c:87-150)."""
        p = self.prec.t
        ya, xa = y.abs(), x.abs()
        zero = ~((ya > 0.0) | (xa > 0.0))
        z = p(torch.minimum(ya, xa) / torch.clamp(torch.maximum(ya, xa), min=float(np.float32(1e-45))))
        alpha = p(z * 255.0)
        idx = torch.clamp(alpha.to(torch.int64), 0, 255)
        frac = p(alpha - idx.to(torch.float32))
        t0, t1 = self.table[idx], self.table[idx + 1]
        base = torch.where(z < float(np.float32(0.003921569)), z, p(t0 + p(p(t1 - t0) * frac)))
        pi, hpi = float(np.float32(np.pi)), float(np.float32(np.pi / 2))
        ang = torch.where(
            xa > ya,
            torch.where(x >= 0.0, torch.where(y >= 0.0, base, -base),
                        torch.where(y >= 0.0, pi - base, base - pi)),
            torch.where(y >= 0.0, torch.where(x >= 0.0, hpi - base, hpi + base),
                        torch.where(x >= 0.0, base - hpi, -hpi - base)))
        return torch.where(zero, torch.zeros_like(ang), p(ang))

    def block(self, x: torch.Tensor, st: FrontState, dop=None):
        """x (B, 2L) float32 -> (y3 (B/d, L) float32, the next state)."""
        p = self.prec.t
        b, c = x.shape[0], x.shape[1] // 2
        d = self.radio.decimation
        x = p(x) if dop is None else self.nco(x, dop)
        y1 = self.fir(torch.cat([st.lpf1, x]), self.taps1, 1, b)
        prev = torch.cat([st.quad, y1[:-1]])
        i, q, si, sq = y1[:, :c], y1[:, c:], prev[:, :c], prev[:, c:]
        re = p(p(i * si) + p(q * sq))
        im = p(p(q * si) - p(i * sq))
        yq = p(self.gain * self.atan2(im, re))
        y2 = self.fir(torch.cat([st.lpf2, yq]), self.taps2, d, b // d)
        y3 = y2 if self.taps3 is None else self.fir(torch.cat([st.dc, y2]), self.taps3, 1, b // d)

        def tail(h, v):
            return torch.cat([h, v])[-h.shape[0]:].clone() if h.shape[0] else h

        new = FrontState(tail(st.lpf1, x), y1[b - 1:].clone(), tail(st.lpf2, yq),
                         None if st.dc is None else tail(st.dc, y2))
        return y3, new


# ---- the clock: Mueller & Mueller with the 8-tap MMSE interpolator


class ClockState(NamedTuple):
    omega: np.ndarray  # (L,) float32
    mu: np.ndarray  # (L,) float32
    last: np.ndarray  # (L,) float32
    suffix: np.ndarray  # (sfx, L) float32: the last rows of y3
    resid: np.ndarray  # (L,) int64: suffix rows not yet consumed


class Clock:
    """The clock of ``radio`` for a step of ``lanes`` lanes (which sets
    the chunk), in ``prec``."""

    def __init__(self, radio: Radio, lanes: int, block_rows: int, prec: Precision = F32):
        self.p = radio.clock()
        self.sfx = radio.suffix
        self.chunk = radio.chunk(lanes)
        self.k = radio.steps_per_chunk(lanes, block_rows)
        self.bank = prec.n(mmse_bank())
        self.prec = prec

    def init_state(self, lanes: int) -> ClockState:
        f = np.float32
        return ClockState(np.full(lanes, self.p["omega_mid"], f), np.full(lanes, self.p["mu"], f),
                          np.zeros(lanes, f), np.zeros((self.sfx, lanes), f), np.zeros(lanes, np.int64))

    def block(self, y3: np.ndarray, st: ClockState, chunks: int | None = None):
        """y3 (n, L) float32 -> (symbols: a list of L int8 arrays, the
        valid symbols of each lane in order; counts (n_chunks, L); the next
        state).  ``chunks`` walks only the block's first chunks (their
        symbols do not depend on the rows after them)."""
        r = self.prec.n
        f32 = self.prec.name == "float32"
        p = self.p
        y3 = r(np.asarray(y3, np.float32))
        n, lanes = y3.shape
        if chunks is not None:
            y3 = y3[: chunks * self.chunk]
            n = y3.shape[0]
        sfx = self.sfx
        one, neg, zero = np.float32(1.0), np.float32(-1.0), np.float32(0.0)
        om_mid, om_lim = np.float32(p["omega_mid"]), np.float32(p["omega_lim"])
        g_om, g_mu = np.float32(p["gain_omega"]), np.float32(p["gain_mu"])
        half, steps = np.float32(0.5), np.float32(NSTEPS)
        omega, mu, last = st.omega.copy(), st.mu.copy(), st.last.copy()
        ii = sfx - st.resid.astype(np.int64)
        suf = st.suffix
        taps = np.arange(NTAPS)[:, None]
        bank_t = np.ascontiguousarray(self.bank.T)  # (8, 129)
        outs = [[] for _ in range(lanes)]
        counts = []
        resid = st.resid.astype(np.int64)
        for s in range(0, max(n, 1), self.chunk):
            work = np.concatenate([suf, y3[s : s + self.chunk]])
            w = work.shape[0]
            flat = work.T.ravel()  # lane-major: lane l's rows at l * w
            base = np.arange(lanes) * w + taps  # (8, L)
            emitted = np.zeros((self.k, lanes), np.float32)
            valids = np.zeros((self.k, lanes), bool)
            wm8 = w - NTAPS
            for k in range(self.k):
                valid = ii <= wm8
                every = bool(valid.all())
                if not every and not valid.any():
                    break  # every lane is past its buffer: the rest are no-ops
                win = flat[base + np.minimum(ii, wm8)]  # (8, L), C order
                imu = np.minimum(np.rint(r(mu * steps)), NSTEPS).astype(np.intp)
                prod = r(win * bank_t[:, imu])
                if f32:
                    y = np.add.reduce(prod, axis=0)  # row after row: the taps in order
                else:
                    y = prod[0]
                    for j in range(1, NTAPS):
                        y = r(y + prod[j])
                nan = np.isnan(y)
                clean = not nan.any()
                out = y if clean else np.where(nan, zero, y)
                # sgn(last) * y - sgn(y) * last, sgn(v) = -1 for v < 0 else 1
                mm = r(np.where(last < 0, -out, out) - np.where(out < 0, -last, last))
                om_n = r(omega + r(g_om * mm))
                dlt = r(om_n - om_mid)
                om_n = r(om_mid + r(half * r(np.abs(r(dlt + om_lim)) - np.abs(r(dlt - om_lim)))))
                mu_n = r(r(mu + om_n) + r(g_mu * mm))
                fl = np.floor(mu_n)
                mu_n = r(mu_n - fl)
                if every and clean:
                    emitted[k] = out
                    valids[k] = True
                    ii = ii + fl.astype(np.int64)
                    omega, mu, last = om_n, mu_n, out
                    continue
                step = valid & ~nan
                emitted[k] = np.where(valid, out, zero)
                valids[k] = valid
                # a NaN window emits 0 and strides floor(omega), its state kept
                ii = ii + np.where(step, fl, np.where(valid, np.floor(omega), zero)).astype(np.int64)
                omega = np.where(step, om_n, omega)
                mu = np.where(step, mu_n, mu)
                last = np.where(step, out, last)
            counts.append(valids.sum(0))
            for l in range(lanes):
                outs[l].append(emitted[valids[:, l], l])
            resid = np.minimum(w - ii, sfx - 1)
            ii = sfx - resid
            suf = work[w - sfx :]
        symbols = [to_int8(np.concatenate(o)) for o in outs]
        return symbols, np.stack(counts), ClockState(omega, mu, last, suf.copy(), resid)


def to_int8(x: np.ndarray) -> np.ndarray:
    """Soft symbols as upstream's volk_32f_s32f_convert_8i: x * 127,
    clipped, rounded half to even."""
    return np.rint(np.clip(x * np.float32(127.0), -128.0, 127.0)).astype(np.int8)
