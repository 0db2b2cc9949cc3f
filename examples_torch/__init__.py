"""Runnable drivers of the PyTorch/CUDA port, one for each of the JAX
system's ``examples/`` (``python -m examples_torch.<name>``)."""
