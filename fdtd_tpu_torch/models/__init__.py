from .scattering import ScatteringResult, scattering_cross_section

__all__ = ["ScatteringResult", "scattering_cross_section"]
