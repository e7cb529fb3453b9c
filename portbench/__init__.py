"""The benchmark of the PyTorch/CUDA port (`repro_torch`) on one H100.

One command runs one cell (a configuration under a traffic mix):

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by name
(`portbench.spec`); see README.md.
"""
