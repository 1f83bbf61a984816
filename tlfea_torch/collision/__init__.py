"""Collision backends (port of `tlfea/collision/`): the hydroelastic
contact-patch pipeline (broadphase, narrowphase, forces), the on-device DEM
backends and the bridge to an external DEM engine."""

from tlfea_torch.collision import (  # noqa: F401
    broadphase, dem, dem_bridge, forces, gridhash, hydroelastic, narrowphase,
)
