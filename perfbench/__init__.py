"""The benchmark of the PyTorch port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything a cell needs is found by name: its
configuration in ``configs/``, its traffic in ``traffic/``, the limits
of its correctness check in ``limits/``, the driver of its configuration
kind in ``drivers/``, the plug-in of a trained model's kind in
``models/`` and each per-layer metric's reader in ``metrics/``.
``inputs`` makes the data, the weights and the draws from the seed and
hands the same to the program and to ``reference/``, the plain PyTorch
re-implementation that decides ``correct``. ``counts/`` holds the frozen
operation and byte formulas and the card's peaks.
"""
