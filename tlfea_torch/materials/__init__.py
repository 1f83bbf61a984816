"""Materials (port of `tlfea/materials`): St. Venant-Kirchhoff and
compressible Mooney-Rivlin, each with Kelvin-Voigt damping."""

from tlfea_torch.materials.mooney_rivlin import MooneyRivlin
from tlfea_torch.materials.svk import SVK, lame_from_E_nu

__all__ = ["SVK", "MooneyRivlin", "lame_from_E_nu"]
