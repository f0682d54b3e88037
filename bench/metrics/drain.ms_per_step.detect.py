"""Driver-thread ms a step spends waiting for a drained step's device-to-
host copies and handing it to the sink (JobStepper.host_seconds d2h_wait
+ sink), in the detection cell."""
from harness import readers


def read(win):
    return readers.host_ms_per_step(win, "d2h_wait", "sink")
