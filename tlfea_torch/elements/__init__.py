"""Element families (port of `tlfea/elements`): FEAT10, ANCF3243, ANCF3443."""

from tlfea_torch.elements import assembly, feat10, ancf, ancf3243, ancf3443  # noqa: F401
from tlfea_torch.elements.assembly import ElementBatch  # noqa: F401
