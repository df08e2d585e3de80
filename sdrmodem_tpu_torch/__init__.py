"""sdrmodem_tpu_torch — the GMSK/FSK modem on PyTorch and CUDA.

A port of ``sdrmodem_tpu`` to an NVIDIA Hopper GPU: plain tensor code is
PyTorch, and each Pallas kernel of the JAX package becomes a CUDA C++
kernel under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``).  Module names mirror the JAX package so each
counterpart is easy to find.

The package imports neither JAX nor ``sdrmodem_tpu``: what it needs from
the backend-free modules there is copied here.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"

from sdrmodem_tpu_torch.dsp.fsk_demod import FskDemodConfig, FskDemodulator
from sdrmodem_tpu_torch.dsp.gfsk_mod import GfskModConfig, GfskModulator
from sdrmodem_tpu_torch.dsp.pipeline import DemodPipeline

__all__ = [
    "DemodPipeline", "FskDemodConfig", "FskDemodulator", "GfskModConfig", "GfskModulator",
    "__version__",
]
