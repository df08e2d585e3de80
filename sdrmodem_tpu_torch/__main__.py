"""CLI entry: ``python -m sdrmodem_tpu_torch <config> [--device cpu]`` — the
reference's ``sdr_modem <config>`` analog (src/main.c:15-44)."""
from sdrmodem_tpu_torch.server.tcp_server import main

main()
