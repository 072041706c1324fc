"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output.  Everything a cell needs is
found by name: its model configuration in ``configs/<config>.json``, its
traffic mix in ``traffic/<traffic>.json`` (read by the driver the mix
names, ``drivers/<driver>.py``), its correctness limits in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``.  The plain references (``reference/``) and the
bound functions (``roofline/``) are frozen here: nothing of the port is
used to judge the port.
"""
