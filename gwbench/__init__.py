"""The benchmark of the PyTorch and CUDA port: one cell of
``BENCHMARK.json`` a run (``python3 -m gwbench.run``), driven by the files
of its configuration, traffic mix, limits and metric readers."""
