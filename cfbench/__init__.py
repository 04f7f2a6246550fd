"""The benchmark of `cineform_tpu_torch`, the PyTorch and CUDA codec, on one
NVIDIA H100: `python3 cfbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`.  `BENCHMARK.json` at the checkout's root names the
cells; each configuration, traffic mix and metric is a file of its own
here, found by its name."""
