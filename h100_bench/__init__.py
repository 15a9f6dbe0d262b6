"""The benchmark of ``mav_detection_tpu_torch`` on an NVIDIA H100: ``python3 -m
h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
