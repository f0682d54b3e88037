"""Driver-thread ms a step spends staging the payload in pinned memory and
enqueueing its host-to-device copies (JobStepper.host_seconds['h2d']),
in the detection cell."""
from harness import readers


def read(win):
    return readers.host_ms_per_step(win, "h2d")
