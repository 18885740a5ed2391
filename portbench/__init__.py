"""The benchmark of ``freud_tpu_torch`` on NVIDIA H100 cards.

One command runs one cell (a configuration under a traffic mix) once and
prints one JSON line: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. ``BENCHMARK.json`` at the checkout's root
names the cells; everything that belongs to one configuration, traffic mix
or per-layer metric sits in a file of its own under this folder, found by
its name (``README.md``).

Nothing here imports JAX or the JAX package ``freud_tpu``; the plain
reference under ``reference/`` imports nothing of ``freud_tpu_torch``.
"""
