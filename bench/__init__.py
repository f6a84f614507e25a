"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``bench/run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, traffic mix, per-layer metric or kernel count
is a file of its own, found by the name the manifest gives it:

* ``configs/<config>.json``: the model's sizes, its source and its cuts;
* ``workloads/<cell>.json``: the cell's config, traffic driver and mix
  parameters, and the limits its outputs are held to;
* ``traffic/<driver>.py``: one driver a kind of traffic (``run(run)``);
* ``metrics/<metric>.py``: one reader a per-layer metric (``read(ctx)``);
* ``roofline/``: the peaks, each kernel's operations and bytes a launch,
  and the whole step's useful operations for ``mfu``;
* ``probes/<kernel>.py``: records of a kernel's launches in a traced run;
* ``reference/``: the plain float32 reference; it imports nothing of the
  program.

Nothing here imports ``jax`` or the JAX package ``repro``.
"""
