"""Benchmark of the PyTorch/CUDA port ``repro_torch``: the coded training
round of CodedPrivateML on one card.  ``run.py`` runs one cell of
``BENCHMARK.json``; see ``PERF.md`` at the repository's root."""
