"""The benchmark of modal_tpu_torch: `python -m benchmark.run --workload <cell>`."""
