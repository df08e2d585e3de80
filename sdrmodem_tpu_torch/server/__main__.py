from sdrmodem_tpu_torch.server.tcp_server import main

main()
