"""The benchmark of ``equss_tpu_torch`` on NVIDIA H100 cards.

One run measures one cell of ``BENCHMARK.json`` (a model configuration
under one traffic mix) and prints one JSON line; see ``README.md``.
Everything the runs are judged by lives here: traffic generation, the
weights drawn from the seed, the FLOP and byte counts, the peaks, the
reduction of a profiler trace to per-layer metrics and the plain
reference that decides ``correct``.
"""
