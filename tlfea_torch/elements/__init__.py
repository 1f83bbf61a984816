"""Element families (port of `tlfea/elements`): FEAT10 so far."""

from tlfea_torch.elements import assembly, feat10  # noqa: F401
from tlfea_torch.elements.assembly import ElementBatch  # noqa: F401
