"""The benchmark of ``moolib_tpu_torch`` on one NVIDIA H100.

``python3 cellbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Every part of a cell is found by its name: its configuration
in ``configs/``, its traffic mix in ``traffic/``, its limits in
``limits/``, each metric's reader in ``metrics/``, the program's model
for its family in ``families/``, its loop in ``loops/`` and its counts
in ``flops/``. ``reference/`` is the plain PyTorch reference that decides
``correct``; it imports nothing of the program.
"""
