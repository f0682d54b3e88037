"""Metadata subsystem: UTC time axis + instrument calibration chain.

Copies of the reference's ``meta/`` modules (stdlib only).

Everything needed to turn anonymous record-indexed feature arrays into
interoperable labeled datasets: filename-timestamp parsing
(:mod:`repro_torch.meta.timestamps`) and the hydrophone calibration model
(:mod:`repro_torch.meta.instrument`).  Pure stdlib — safe to import from any
layer without cycles.
"""
from repro_torch.meta.instrument import Instrument
from repro_torch.meta.timestamps import (TimestampParseError,
                                         format_utc, parse_timestamp,
                                         timestamps_for)

__all__ = [
    "Instrument",
    "TimestampParseError",
    "format_utc",
    "parse_timestamp",
    "timestamps_for",
]
