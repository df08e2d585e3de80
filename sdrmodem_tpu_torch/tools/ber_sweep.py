"""TX -> channel (AWGN + frequency offset) -> RX loopback BER sweep on the port.

The twin of the JAX package's ``tools/ber_sweep.py`` (BASELINE.json config
#3): modulate a random payload on the port's modulator (B5 on the card),
impair it with white Gaussian noise and a carrier offset on the host, and
demodulate:

- the sweep (default): every SNR point one lane of one full-block step
  (``make_batched_step_full("pallas")``: B1 and B2 on the card), the
  server's fast path;
- ``--point-mode``: each point's whole stream through ``FskDemodulator``
  (float32; the FIRs and B4 on the card).

The channel is host-side numpy, copied from the JAX tool (``_channel``,
``_ber``), so one seed gives both tools the same noise.  Prints the JAX
tool's JSON.

Usage: python -m sdrmodem_tpu_torch.tools.ber_sweep [--snrs 0,2,4,...]
       [--offset-hz 200] [--bytes 2048] [--seed 0] [--point-mode]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig, FskDemodulator
from sdrmodem_tpu_torch.dsp.gfsk_mod import GfskModConfig, GfskModulator
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline
from sdrmodem_tpu_torch.ops._build import resolve_device
from sdrmodem_tpu_torch.tools._common import add_device, start

RADIO = (48000, 9600, 5000)  # fs, baud, deviation


def _tx_and_bits(n_bytes: int, seed: int, fs: int, baud: int, dev: int, device):
    """Modulate a random payload; returns (iq complex64 host array, tx bits)."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, n_bytes).astype(np.uint8)
    mod = GfskModulator(GfskModConfig.from_radio(fs, baud, dev), device=device)
    i, q, _ = mod.process_pair_kernel(torch.from_numpy(payload).to(mod.device))
    iq = (i.cpu().numpy() + 1j * q.cpu().numpy()).astype(np.complex64)
    bits = np.unpackbits(payload).astype(np.int8) * 2 - 1
    return iq, bits


def _channel(iq: np.ndarray, snr_db: float, offset_hz: float, fs: int, rng):
    """AWGN at the requested Es/N0 (signal power 1.0 by construction) plus
    an optional carrier offset; host-side numpy, complex only on the host."""
    noise_power = 10 ** (-snr_db / 10.0)
    noise = (
        rng.standard_normal(len(iq)) + 1j * rng.standard_normal(len(iq))
    ).astype(np.complex64) * np.sqrt(noise_power / 2.0)
    rx = (iq + noise).astype(np.complex64)
    if offset_hz:
        n = np.arange(len(iq), dtype=np.float64)
        rx = rx * np.exp(2j * np.pi * offset_hz / fs * n).astype(np.complex64)
    return rx


def _ber(hard: np.ndarray, bits_tx: np.ndarray, skip: int = 128):
    """Best-alignment bit error rate, skipping the filter warm-up (the DC
    blocker alone delays by 2*(L-1) samples ~ 64 symbols)."""
    best_err, best_n = 1.0, 1
    for off in range(0, 220):
        n = min(len(hard) - off - skip, len(bits_tx) - skip)
        if n <= 100:
            break
        errs = float(
            (hard[skip + off : skip + off + n] != bits_tx[skip : skip + n]).mean()
        )
        if errs < best_err:
            best_err, best_n = errs, n
    return best_err, best_n


def run_point(snr_db: float, offset_hz: float, n_bytes: int, seed: int, device=None):
    """One point's BER through the whole-stream ``FskDemodulator``."""
    fs, baud, dev = RADIO
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    iq, bits_tx = _tx_and_bits(n_bytes, seed, fs, baud, dev, device)
    rx = _channel(iq, snr_db, offset_hz, fs, rng)

    demod = FskDemodulator(FskDemodConfig(fs, baud, dev, 1, 2000, True), exact=False, device=device)
    out, count, _ = demod.process(rx)
    soft = out.cpu().numpy()[: int(count)]
    hard = np.sign(soft).astype(np.int8)
    return _ber(hard, bits_tx)


def run_sweep_batched(snrs, offset_hz: float, n_bytes: int, seed: int, block: int = 32768, device=None):
    """Every SNR point a lane of one full-block step."""
    fs, baud, dev = RADIO
    device = resolve_device(device)
    iq, bits_tx = _tx_and_bits(n_bytes, seed, fs, baud, dev, device)

    lanes = []
    for k, snr in enumerate(snrs):
        rng = np.random.default_rng(seed + 1000 + k)
        lanes.append(_channel(iq, snr, offset_hz, fs, rng))
    rxs = np.stack(lanes)  # (C, N) complex64 on the host only

    cfg = FskDemodConfig(fs, baud, dev, 1, 2000, True)
    blk = min(block, -(-rxs.shape[1] // cfg.decimation) * cfg.decimation)
    pipe = DemodPipeline(cfg, blk, exact=False, use_atan_lut="free", device=device)
    step = pipe.make_batched_step_full("pallas")
    state = pipe.init_full_state(len(snrs))

    n = rxs.shape[1]
    padded = np.zeros((len(snrs), -(-n // blk) * blk), np.complex64)
    padded[:, :n] = rxs
    outs = [[] for _ in snrs]
    for start_ in range(0, padded.shape[1], blk):
        chunk = padded[:, start_ : start_ + blk]
        x = np.stack([chunk.real, chunk.imag], axis=1).astype(np.float32)  # (C, 2, blk)
        state, sym, cnt = step(state, torch.from_numpy(x).to(device))
        sym, cnt = sym.cpu().numpy(), cnt.cpu().numpy()  # (C, n_chunks, K), (C, n_chunks)
        for c in range(len(snrs)):
            for k in range(cnt.shape[1]):
                if cnt[c, k]:
                    outs[c].append(sym[c, k, : int(cnt[c, k])])

    points = []
    for c, snr in enumerate(snrs):
        soft = np.concatenate(outs[c]) if outs[c] else np.zeros(0, np.int8)
        hard = np.sign(soft).astype(np.int8)
        ber, nbits = _ber(hard, bits_tx)
        points.append({"snr_db": float(snr), "ber": ber, "bits": nbits})
    return points


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--snrs", default="0,2,4,6,8,10,12")
    parser.add_argument("--offset-hz", type=float, default=0.0)
    parser.add_argument("--bytes", type=int, default=2048)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--point-mode", action="store_true",
                        help="per-point whole-stream FskDemodulator")
    add_device(parser)
    args = parser.parse_args(argv)
    device = start(args.device)

    snrs = [float(s) for s in args.snrs.split(",")]
    if args.point_mode:
        points = []
        for snr in snrs:
            ber, n = run_point(snr, args.offset_hz, args.bytes, args.seed, device)
            points.append({"snr_db": snr, "ber": ber, "bits": n})
            print(json.dumps(points[-1]))
        return points

    points = run_sweep_batched(snrs, args.offset_hz, args.bytes, args.seed, device=device)
    print(json.dumps({
        "metric": "ber_sweep",
        "platform": device.type,
        "offset_hz": args.offset_hz,
        "points": points,
    }))
    return points


if __name__ == "__main__":
    main()
