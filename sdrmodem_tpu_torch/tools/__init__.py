"""Tools on the port, run as ``python -m sdrmodem_tpu_torch.tools.<name>``:
``parity`` (the golden-parity gate), ``multihost`` (one time mesh across
processes), ``graft_entry`` (the entry point and the sharded dry run), and
the twins of the JAX package's ``tools/``: ``perf``, ``latency``,
``ber_sweep``, ``trace``, ``profile_step``, ``profile_front`` and
``profile_variants``.  Each runs on the card unless given ``--device cpu``
(``_common.py``)."""
