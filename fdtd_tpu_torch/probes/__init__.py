from .farfield import BoxDft, radiation_pattern
from .probes import (
    DftProbe,
    EnergyProbe,
    FieldComponent,
    LineProbe,
    PointProbe,
    PoyntingFluxProbe,
    SliceProbe,
)

__all__ = [
    "BoxDft",
    "radiation_pattern",
    "DftProbe",
    "LineProbe",
    "EnergyProbe",
    "FieldComponent",
    "PointProbe",
    "PoyntingFluxProbe",
    "SliceProbe",
]
