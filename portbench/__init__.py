"""portbench: the benchmark of the PyTorch/CUDA port (`repro_torch`).

One command runs one cell once (see `run.py`). Everything that belongs to
one configuration, traffic mix, per-layer metric or kernel cost sits in a
file of its own, found by the name `BENCHMARK.json` gives it:

* ``configs/<config>.json``  the deployment's sizes, source and cuts;
* ``mixes/<mix>.json``       the traffic's parameters and the limits of the
                             correctness check, run by ``drivers/<driver>.py``;
* ``metrics/<metric>.py``    one per-layer reader over a traced run;
* ``costs/<kernel>.py``      a kernel's frozen byte and operation count.

The generators (``gen/``), the plain reference (``reference/``), the peaks
(``peaks.json``) and the comparison (``lib/judge.py``) are the yardstick:
nothing under ``reference/`` imports the program.
"""
