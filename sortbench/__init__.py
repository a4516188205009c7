"""The benchmark of the PyTorch/CUDA port (``repro_torch``): sort jobs on
the H100.  ``python3 sortbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` runs one cell once."""
