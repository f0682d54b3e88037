"""DEPAM on PyTorch and CUDA — the port of the ``repro`` package.

The subpackages mirror ``repro``'s layout (``core``, ``kernels``,
``api``, ``data``, ``distributed``, ``faults``, ``meta``) so each
module's counterpart is found by name.  The package imports ``torch``
and numpy only; the seven kernels of the paper's welch/spl/tol path and
of the detection path (spectrogram, events, impulsive metrics) are
hand-written CUDA C++
for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.

Everything runs on the CUDA device unless the caller asks for the CPU
(``api.job(...).device("cpu")``), where each kernel wrapper takes its
plain PyTorch version instead.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
