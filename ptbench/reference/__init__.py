"""The plain reference the benchmark judges the program's outputs against: plain
PyTorch and NumPy, independent of the program."""
