"""The benchmark of `instant_ngp_tpu_torch` on one NVIDIA H100
(`python3 ngp_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`; README.md)."""
