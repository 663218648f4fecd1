"""The benchmark of the PyTorch and CUDA port (`repro_torch`): PD-disaggregated
serving through TENT's KV handoff on one card. `run.py` is the command;
everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own under `configs/`, `traffic/`, `workloads/` and
`metrics/`, found by the names `BENCHMARK.json` gives."""
