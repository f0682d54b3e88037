"""Hand-written CUDA kernels for Hopper (``csrc/``), each with its plain
PyTorch version beside it; ``ops`` dispatches between them and
``roofline`` models what each call costs on the card."""
