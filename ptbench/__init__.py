"""Benchmark of the PyTorch/CUDA path tracer: ``python3 -m ptbench.run``."""
