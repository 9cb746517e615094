"""The benchmark of the PyTorch/CUDA port (``rabitq_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` once, on the machine it
is started on:

    python3 -m benchmark.run --workload sift1m.b16384 --seed 7 --seconds 10 --trace 0

Everything is found by name: a configuration in ``configs/<config>.json``,
a traffic mix in ``traffic/<traffic>.json``, a cell's correctness limits
in ``limits/<cell>.json`` and a per-layer metric's reader in
``metrics/<metric>.py``. Nothing here imports jax or the JAX package, and
the yardstick (data, ground truth, work counts, peaks, the comparison
that decides ``correct``) is this folder's own. Beside the measured
command: ``control`` (the readings a cell's limits are set from),
``sweep`` (recall at other probes, to set a cell's probe) and
``rehearse`` (every cell at a tiny size on the CPU).
"""
