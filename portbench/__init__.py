"""The benchmark of ``distlearn_tpu_torch`` on an NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
cell or per-layer metric sits in a file of its own, found by its name
(:mod:`portbench.spec`): ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<cell>.json`` and
``metrics/<metric>.py``.  ``reference/`` holds the plain models that
decide ``correct``; it imports nothing of the port.

Nothing here imports ``jax`` or the JAX package.
"""
