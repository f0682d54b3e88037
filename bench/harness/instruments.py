"""The benchmark's own instruments around the program's layers.

A streaming sink built on the program's public ``CallbackSink`` that
keeps what it received for the check and takes the moment each record
arrived, and the program's ``AsyncSink`` with its driver-side enqueues
as spans.  Neither changes behaviour: each hands on to the program.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch import api


class Delivery:
    """What the sink received: each record's values, how many times it
    was delivered, and when it last arrived."""

    def __init__(self):
        self._lock = threading.Lock()
        self.values: dict[str, dict[int, np.ndarray]] = {}
        self.times: dict[int, int] = {}             # record -> deliveries
        self.arrived: dict[int, float] = {}         # record -> time

    def on_values(self, step, indices, values):
        for name, v in values.items():
            d = self.values.setdefault(name, {})
            for i, row in zip(indices.tolist(), v):
                d[i] = row
        t = time.perf_counter()
        with self._lock:
            for i in indices.tolist():
                self.times[i] = self.times.get(i, 0) + 1
                self.arrived[i] = t

    def delivered(self) -> int:
        with self._lock:
            return len(self.arrived)

    def sink(self):
        return api.CallbackSink(self.on_values)


def spanned_async_sink(spans):
    """The program's background writer, its driver-side enqueues (which
    block when the writer falls behind) as spans."""

    class SpannedAsyncSink(api.AsyncSink):
        def write(self, step, indices, values):
            with spans.span("sink.enqueue"):
                super().write(step, indices, values)

        def commit(self, plan, step, agg, live):
            with spans.span("sink.enqueue"):
                super().commit(plan, step, agg, live)

    return SpannedAsyncSink
