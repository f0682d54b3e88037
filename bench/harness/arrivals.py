"""Open-loop arrivals, the one generator every fed mix uses.

A mix's ``arrivals`` is a list of phases, each ``{"seconds": s,
"rate_per_s": r}``, cycled in order through the window: one phase is a
fixed rate, two make on/off bursts.  The schedule depends on the mix
alone, never on the seed or the host, so every run offers the same
load.  A pusher thread pushes record ``k`` of the window at its due
time, whatever the program does; a push that the program blocks (a
full ring) makes the later ones late, and each push's lateness is kept.
"""
from __future__ import annotations

import threading
import time

import numpy as np


def schedule(phases: list[dict], seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of every arrival in
    ``[0, seconds)``, ascending."""
    due = []
    t = 0.0
    while t < seconds:
        for ph in phases:
            length, rate = float(ph["seconds"]), float(ph["rate_per_s"])
            if rate > 0:
                k = np.arange(int(np.ceil(length * rate)))
                due.append(t + k / rate)
            t += length
    due = np.concatenate(due) if due else np.zeros(0)
    return due[due < seconds]


class Pusher(threading.Thread):
    """Calls ``push(k)`` at ``t0 + due[k]`` for every ``k``; keeps each
    push's lateness and, after each push, the backlog: records pushed
    and not yet delivered (``delivered()`` counts those)."""

    def __init__(self, push, due: np.ndarray, t0: float, delivered):
        super().__init__(name="bench-pusher")
        self.push, self.due, self.t0 = push, due, t0
        self.delivered = delivered
        self.late = np.zeros(len(due))
        self.backlog: list[tuple[float, int]] = []

    def run(self):
        for k, d in enumerate(self.due):
            wait = self.t0 + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.push(k)
            self.late[k] = time.perf_counter() - self.t0 - d
            self.backlog.append((float(d), k + 1 - self.delivered()))
