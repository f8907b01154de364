"""The benchmark of the PyTorch/CUDA port (``relightableavatar_tpu_torch``).

One run of one cell: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (``run.py``); the readings that the limits
were set from: ``python3 -m portbench.control`` (``control.py``).  Cells,
configurations, traffic, entries and per-layer metrics are found by name
(``spec.py``); the plain reference is ``reference/``.
"""
