"""Shared step-function cache — tenants with matching configs share one.

Building a tenant's step is the service's cold-start cost on the port:
it resolves every feature's setup constants (windows, band matrices,
event thresholds) and moves them onto the device, and a service that
rebuilt per tenant would hold one copy of those device constants per
*submission* instead of one per distinct configuration.  The cache
keys on every argument of the port's :class:`repro_torch.api.engine.
Compiler` seam, which is exactly what determines the function:

  * the **step** — ``(feature specs, manifest, params, kernel toggle,
    device-synth flag, device)`` (see
    :func:`repro_torch.api.engine.compile_step`); specs and manifests
    are frozen dataclasses and ``torch.device`` hashes, so the tuple is
    hashable as-is;
  * the **carry update** — ``(reduction bindings,)``; the bindings
    embed the resolved window spec and per-window state layout, so
    tenants at different window resolutions correctly miss each other.

Sharing is safe because neither function keeps per-job state: the step
closes over read-only device constants and builds a fresh
``FeatureContext`` per call, and the carry update writes, in place, the
carry it is handed with ``(state, outputs, segments, index, graphs)``.
All per-job state (carry, staging slots, streams, and the CUDA graphs of
the step's chains with their static buffers, which the stepper hands to
both functions on each call) lives on each tenant's
:class:`~repro_torch.api.engine.JobStepper`.

One difference from the reference's cache (``repro.serve.
compile_cache``): its keys also hold XLA buffer-donation flags, and its
carry-update key holds whether the carry is donated, which is off for
sinks that persist the carry.  The port has no donation, so a
store-backed tenant and an in-memory tenant with the same reductions
share one carry update here where the reference compiles two; for
tenants that do not differ that way the hit/miss accounting is the
reference's.  The step key holds no payload transport either: the
step dispatches on the payload tensor's dtype, so a float32 tenant and
an int16 tenant with the same configuration share one step function,
where the reference keys on the transport.  A mesh of D distinct
devices asks once per device (the reference once per mesh).

Both maps live behind one lock (submissions may arrive from any
thread) and count hits/misses per kind — ``stats()`` is the service's
cold-vs-warm observability hook.
"""
from __future__ import annotations

import threading
from typing import Callable

from repro_torch.api import engine


class CompileCache(engine.Compiler):
    """A :class:`repro_torch.api.engine.Compiler` with shared functions
    and hit/miss counters; one instance per :class:`SoundscapeService`,
    handed to every tenant's :class:`~repro_torch.api.engine.
    JobStepper`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {"step": {}, "reduce": {}}
        self._hits = {"step": 0, "reduce": 0}
        self._misses = {"step": 0, "reduce": 0}

    def _get(self, kind: str, key, build: Callable):
        with self._lock:
            if key in self._entries[kind]:
                self._hits[kind] += 1
                return self._entries[kind][key]
            # miss counted up front: a failed build should not be
            # silently retried as another "first" build
            self._misses[kind] += 1
        # build OUTSIDE the lock: moving constants to the device must not
        # serialize against other tenants' lookups.  Two concurrent
        # first misses of one key both build; the first stored wins and
        # both callers get it.
        fn = build()
        with self._lock:
            self._entries[kind].setdefault(key, fn)
            return self._entries[kind][key]

    def step(self, specs, m, p, use_kernels, device_synth, device) -> Callable:
        key = (specs, m, p, use_kernels, device_synth, device)
        return self._get(
            "step", key,
            lambda: engine.compile_step(specs, m, p, use_kernels,
                                        device_synth, device))

    def reduce(self, bindings) -> Callable:
        return self._get("reduce", (bindings,),
                         lambda: engine.compile_reduce_update(bindings))

    def stats(self) -> dict:
        """``{"step": {"hits", "misses", "entries"}, "reduce": {...}}``."""
        with self._lock:
            return {kind: {"hits": self._hits[kind],
                           "misses": self._misses[kind],
                           "entries": len(self._entries[kind])}
                    for kind in ("step", "reduce")}
