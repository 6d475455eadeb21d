"""The port's benchmark: ``repro_torch`` registering TEM series on the card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything a cell
needs is found by name: ``configs/<config>.json``, ``traffic/<mix>.json``
and, for each per-layer metric, ``metrics/<metric>.py``.  The yardstick
(the series generator, the plain reference, the trace reduction, the peaks
and the comparisons that decide ``correct``) lives here and imports nothing
of the program.
"""
