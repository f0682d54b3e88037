"""Device operations (kernels, copies, fills) in the traced window per
step, in the detection cell."""
from harness import readers


def read(win):
    return readers.device_ops_per_step(win)
