"""The benchmark of volumerenderer_tpu_torch: the harness, the traffic
generator, the plain reference and the trace reader.  Run it with
``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
