"""Materials (port of `tlfea/materials`): St. Venant-Kirchhoff so far."""

from tlfea_torch.materials.svk import SVK, lame_from_E_nu

__all__ = ["SVK", "lame_from_E_nu"]
