"""portbench: the benchmark of the PyTorch/CUDA port (`repro_torch`).

One command runs one cell once (see `run.py`). Everything that belongs to
one configuration, traffic mix, driver, per-layer metric or kernel cost
sits in a file of its own, found by the name `BENCHMARK.json` gives it, so
a cell of any driver joins from new files and entries alone:

* ``configs/<config>.json``  the deployment's or model's sizes, source and cuts;
* ``mixes/<mix>.json``       the traffic's parameters and the limits of the
                             correctness check, exactly the names its
                             driver's ``LIMITS`` declares;
* ``drivers/<driver>.py``    set-up, the window, the check (``LIMITS``), and
                             ``SMALL``: the keys of its cells' configuration
                             and mix, with their values, that cut a cell to a
                             size the CPU tests run in a second
                             (`lib/smallcell.py`; every key must be one the
                             cell holds);
* ``metrics/<metric>.py``    one per-layer reader over a traced run;
* ``costs/<kernel>.py``      a kernel's frozen byte and operation count
                             (``bound_s``), or a model step's (``flops``).

The generators (``gen/``), the plain references (``reference/``), the
peaks (``peaks.json``: the H100's HBM, INT32, tensor-core and FP32 rates),
the readers' arithmetic (``lib/readers.py``: ``roofline_share`` for
``<kernel>_roofline`` metrics, ``mfu_share`` for ``<model>.mfu`` metrics)
and the comparisons (``lib/judge.py``) are the yardstick: nothing under
``reference/`` imports the program.
"""
