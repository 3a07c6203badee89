"""perfbench: the benchmark of the PyTorch and CUDA port (see PERF.md)."""
