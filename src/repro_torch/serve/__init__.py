"""Serving layer: multi-tenant streaming soundscape service.

One long-lived :class:`SoundscapeService` runs many concurrent
soundscape jobs over one device — a shared :class:`CompileCache` of
step and carry-update functions, a fair scheduler (:class:`RoundRobin` /
:class:`DeficitRoundRobin`) interleaving bounded step-quanta, and
:class:`LiveSource` ring buffers admitting real-time streams beside
batch wav corpora.
"""
from .compile_cache import CompileCache
from .live import LiveSource, RingOverrun
from .restart import RestartPolicy
from .scheduler import DeficitRoundRobin, RoundRobin, Scheduler
from .service import SoundscapeService, TenantHandle

__all__ = [
    "CompileCache",
    "DeficitRoundRobin",
    "LiveSource",
    "RestartPolicy",
    "RingOverrun",
    "RoundRobin",
    "Scheduler",
    "SoundscapeService",
    "TenantHandle",
]
