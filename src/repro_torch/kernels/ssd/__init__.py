from .kernel import ssd_cuda
from .kernel_bwd import ssd_bwd_cuda
from .ops import ssd, ssd_plain
from .ref import ssd_bwd_plain

__all__ = ["ssd", "ssd_cuda", "ssd_plain", "ssd_bwd_cuda", "ssd_bwd_plain"]
