"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA H100s.

One command runs one cell::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a cell in ``workloads/<cell>.json`` names a
model configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``), the mix names its driver
(``drivers/<driver>.py``), and each per-layer metric of ``BENCHMARK.json``
is read by ``metrics/<metric>.py``.  The plain fp32 references that decide
``correct`` live in ``reference/`` and import nothing of the port.
"""
