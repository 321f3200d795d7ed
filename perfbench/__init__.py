"""The benchmark of epgpy_torch on one NVIDIA H100 (see BENCHMARK.json and
PERF.md).  ``python perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once and prints one JSON line.
"""
