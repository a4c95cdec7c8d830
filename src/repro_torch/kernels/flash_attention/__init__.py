from .kernel import flash_attention_cuda
from .kernel_bwd import flash_attention_bwd_cuda
from .ops import flash_attention, flash_attention_plain
from .ref import flash_attention_bwd_plain, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_cuda", "flash_attention_plain",
           "flash_attention_ref", "flash_attention_bwd_cuda",
           "flash_attention_bwd_plain"]
