"""The plain reference the benchmark judges the program's outputs against: plain
PyTorch and NumPy, independent of the program. A configuration names its
reference module here (``"reference"``, by default ``trace``); the protocol
such a module keeps is in ``check.py``."""
