"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: one cell
of ``BENCHMARK.json`` run once by ``perfbench/run.py``.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name ``BENCHMARK.json`` gives it
(``perfbench.spec``): ``configs/<config>.json``, ``traffic/<mix>.json``
(read by the generator ``gen/<kind>.py`` its ``kind`` names),
``e2e/<metric>.py`` and ``metrics/<metric>.py``.  The reference that
decides ``correct`` is in ``reference/`` and imports nothing of the port.
"""
