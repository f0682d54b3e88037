"""Instrument provenance — the pypam/pyhydrophone calibration model.

A hydrophone deployment is characterised by three numbers: the
hydrophone's receive sensitivity (dB re 1 V/µPa, typically around
-165), any amplifier/preamp gain (dB), and the recorder ADC's peak-to-
peak input voltage.  Together they fix the linear factor that converts
a normalised waveform sample (full scale = ±1) to pressure in µPa:

    gain = (vpp / 2) / 10 ** ((sensitivity_db + gain_db) / 20)

That single float is exactly what ``data/wavio`` already threads
through the pipeline as the per-file calibration gain — this module
makes the physical provenance the source of truth and *derives* the
number, instead of users hand-supplying an anonymous scalar.

The record is frozen and hashable so it can ride manifests and compile
-cache keys, and it serialises to a plain dict (``to_state``) that the
store commits next to the cursor: a resumed run that presents different
calibration is refused loudly rather than silently mixing two pressure
scales in one output.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Instrument:
    """A calibrated recording chain (hydrophone + preamp + ADC).

    sensitivity_db: hydrophone receive sensitivity, dB re 1 V/µPa
        (negative for real hydrophones, e.g. -165.0).
    gain_db:        amplifier gain applied before the ADC, dB.
    vpp:            ADC peak-to-peak input voltage (full scale spans
                    ±vpp/2); 2.0 models a ±1 V converter.
    name:           free-form label ("SoundTrap ST300 #5112"), carried
                    into output attrs only.
    """

    sensitivity_db: float
    gain_db: float = 0.0
    vpp: float = 2.0
    name: str = ""

    def __post_init__(self) -> None:
        if not (self.vpp > 0.0):
            raise ValueError(
                f"Instrument vpp must be a positive peak-to-peak voltage,"
                f" got {self.vpp!r}")
        for field in ("sensitivity_db", "gain_db", "vpp"):
            v = getattr(self, field)
            if v != v or v in (float("inf"), float("-inf")):
                raise ValueError(
                    f"Instrument {field} must be finite, got {v!r}")

    @property
    def gain(self) -> float:
        """Linear counts->µPa factor for full-scale-normalised samples."""
        return (self.vpp / 2.0) / 10.0 ** (
            (self.sensitivity_db + self.gain_db) / 20.0)

    def to_state(self) -> dict:
        """JSON-safe dict committed with the cursor (resume identity)."""
        return {
            "sensitivity_db": float(self.sensitivity_db),
            "gain_db": float(self.gain_db),
            "vpp": float(self.vpp),
            "name": str(self.name),
        }

    @classmethod
    def from_state(cls, state: dict) -> "Instrument":
        return cls(sensitivity_db=float(state["sensitivity_db"]),
                   gain_db=float(state.get("gain_db", 0.0)),
                   vpp=float(state.get("vpp", 2.0)),
                   name=str(state.get("name", "")))

    def as_attrs(self) -> dict:
        """CF-ish attrs stamped on labeled outputs (zarr/netCDF)."""
        attrs = {
            "instrument_sensitivity_db_re_1V_per_uPa":
                float(self.sensitivity_db),
            "instrument_gain_db": float(self.gain_db),
            "instrument_vpp_volts": float(self.vpp),
            "instrument_calibration_gain_uPa": float(self.gain),
        }
        if self.name:
            attrs["instrument_name"] = self.name
        return attrs
