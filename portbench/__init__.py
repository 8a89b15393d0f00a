"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; everything a cell needs is
found by name under this folder: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``workloads/<cell>.json`` (the limits of the
comparison that decides ``correct``), ``metrics/<metric>.py`` (one reader
per per-layer metric), ``flops/<family>.py`` and ``reference/<family>.py``
(its ``layout``; its ``layer``, or its own ``loss_and_grad`` and
``stacks``: ``reference/_common.py``), and for the CPU tests
``tests/smoke/<family>.json`` (the family's smoke size and limits).
Nothing here imports ``jax`` or the JAX package ``repro``.
"""
