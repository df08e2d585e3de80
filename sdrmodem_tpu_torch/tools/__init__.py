"""Tools on the port, run as ``python -m sdrmodem_tpu_torch.tools.<name>``:
``parity`` (the golden-parity gate) and ``multihost`` (one time mesh across
processes)."""
