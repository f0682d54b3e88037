"""Driver-thread ms a step spends enqueueing the step's kernels and ops,
the carry update and the device-to-host copies
(JobStepper.host_seconds['dispatch']), in the detection cell."""
from harness import readers


def read(win):
    return readers.host_ms_per_step(win, "dispatch")
