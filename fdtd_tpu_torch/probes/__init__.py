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
    "DftProbe",
    "LineProbe",
    "EnergyProbe",
    "FieldComponent",
    "PointProbe",
    "PoyntingFluxProbe",
    "SliceProbe",
]
