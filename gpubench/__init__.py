"""The benchmark of the PyTorch and CUDA port (`repro_torch`) on NVIDIA GPUs.

One run is one process: ``python gpubench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``. See `harness` for how cells, traffic,
configurations and metrics are found by name.
"""
