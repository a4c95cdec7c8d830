from .kernel import ssd_cuda
from .ops import ssd, ssd_plain

__all__ = ["ssd", "ssd_cuda", "ssd_plain"]
