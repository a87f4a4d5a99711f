"""The benchmark of the PyTorch and CUDA port (``sr_torch``): see
``srbench/run.py`` and ``srbench/harness.py``."""
