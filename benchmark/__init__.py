"""The benchmark of the ``dynamo_depth_torch`` training step on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root of the repository names the cells, the
configurations and the metrics; each is found by its name among the files
here (``spec.py``). ``program.py`` is the only module that imports the
program; ``reference/`` is the frozen plain step it is held to.
"""
