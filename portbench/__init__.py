"""The benchmark of the PyTorch and CUDA port: see ``harness.py`` and ``run.py``."""
