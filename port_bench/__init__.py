"""The benchmark of ``mobius_rag_tpu_torch`` on one NVIDIA H100: the cells
of ``BENCHMARK.json`` at the repository's root, run one at a time by
``python3 -m port_bench.run`` (see ``run.py``). The harness imports
neither JAX nor the JAX package; only ``system.py`` (with ``run.py``,
``control.py`` and ``sweep.py``, which drive it) imports the system under
test, and the reference (``reference.py``, ``reftext.py``) imports
nothing of it."""
