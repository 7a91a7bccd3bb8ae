"""The benchmark of ``torcheval_tpu_torch``, the PyTorch and CUDA port.

``python3 evalbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once on one CUDA device and prints one JSON
line. See ``evalbench/core/harness.py`` for what a run does.
"""
