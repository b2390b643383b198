"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell of
``BENCHMARK.json`` a run, ``python3 portbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``."""
