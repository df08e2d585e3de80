"""The plain reference the benchmark holds the port to.

Plain NumPy and PyTorch, independent of the port: it imports nothing of
``sdrmodem_tpu_torch`` (nor JAX or the JAX package), designs its own taps
and tables, and propagates its own orbits (``orbit/``, a frozen copy of the
upstream SGP4 the port also follows)."""
