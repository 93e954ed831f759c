"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  A cell
names a configuration (``bench/configs/<config>.json``) and a traffic mix
(``bench/traffic/<mix>.json``); every metric is a reader of its own
(``bench/metrics/<metric>.py``).  The work counts and peaks
(``work.py``), the plain reference (``reference.py``) and the comparison
that decides ``correct`` live here and import nothing of the port.
"""
