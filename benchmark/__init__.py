"""The benchmark of the PyTorch and CUDA port (``sdrmodem_tpu_torch``).

Run from the root of a checkout: ``python3 benchmark/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>`` (see README.md here)."""
