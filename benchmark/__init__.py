"""The benchmark of the PyTorch/CUDA port (``pbwt_tpu_torch``) on one H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line last. Each cell is found by name: its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json`` (which
names its driver in ``drivers/``), each metric's reader in
``metrics/<metric>.py``. The yardstick lives here too: the input generator
(``generators/``), the plain references (``reference/``), the rooflines and
the card's peaks (``rooflines/``).

Nothing here imports ``jax``, ``jaxlib`` or ``pbwt_tpu``; ``reference/``
imports nothing of ``pbwt_tpu_torch`` either.
"""
