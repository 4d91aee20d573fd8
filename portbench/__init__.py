"""The benchmark of the PyTorch/CUDA port ``pdc_tpu_torch``: one run of one
cell is ``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` (see README.md)."""
