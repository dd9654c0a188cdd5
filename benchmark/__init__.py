"""The benchmark of the PyTorch and CUDA port (``imageclust_tpu_torch``).

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON result line. Everything that belongs to one configuration,
traffic mix, cell or metric lives in a file of its own, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json`` (the cell's correctness limits),
``metrics/<metric>.py``, ``kinds/<traffic kind>.py``,
``reference/<family>.py`` (the plain float32 tower) and
``adapters/<family>.py`` (the published weights in the program's input
layout).
"""
