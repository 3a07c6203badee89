"""The plain reference of the benchmark's output checks: plain PyTorch
in float32, importing nothing of the measured program."""
