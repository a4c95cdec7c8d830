from .kernel import decode_attention_cuda
from .ops import decode_attention, decode_attention_plain
from .ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_cuda",
           "decode_attention_plain", "decode_attention_ref"]
