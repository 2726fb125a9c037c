"""The benchmark of odr_audioenc_tpu_torch on one CUDA card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, codec path or
metric is a file of its own, found by name (registry.py): configs/<config>.json,
workloads/<cell>.json, drivers/<driver>.py, traffic/<kind>.py,
reference/<reference>.py and metrics/<metric>.py.
"""
