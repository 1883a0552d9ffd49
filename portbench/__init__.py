"""The benchmark of dsc_tpu_torch on one NVIDIA H100: ``python portbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` (BENCHMARK.json at the repository's root
names the cells and metrics; each piece sits in a file of its own here, found by name)."""
