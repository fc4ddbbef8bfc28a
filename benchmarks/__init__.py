"""The benchmark of ``ntpoly_tpu_torch`` on one or four CUDA cards.

``BENCHMARK.json`` at the repository root names the cells; each cell
is a configuration (``configs/<config>.json``, a deployment: the
Hamiltonian family and its size) under a traffic mix
(``traffic/<traffic>.json``: the library entry, its settings and the
calls' loop), with what belongs to the cell alone in
``workloads/<cell>.json`` (the correctness check's sample and limits,
its controls, the traced span).  The entry's driver is
``entries/<entry>.py``; each per-layer metric is read by
``metrics/<metric>.py``; ``reference/`` is the plain reference that
decides ``correct``.  One run of one cell:

    python3 -m benchmarks.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>
"""
