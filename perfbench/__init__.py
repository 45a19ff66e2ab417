"""The benchmark of ``libre_tpu_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
per-layer metric or kernel sits in a file of its own, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``driver``
names ``drivers/<driver>.py``), ``metrics/<metric>.py``,
``work/<kernel>.py`` and ``limits/<cell>.json``.  ``reference/`` is the
plain PyTorch the outputs are judged against; it imports nothing of the
program.
"""
