from .kernel import decode_attention_cuda
from .ops import (decode_attention, decode_attention_partial,
                  decode_attention_partial_plain, decode_attention_plain)
from .partial import decode_attention_partial_cuda
from .ref import decode_attention_partial_ref, decode_attention_ref

__all__ = ["decode_attention", "decode_attention_cuda",
           "decode_attention_plain", "decode_attention_ref",
           "decode_attention_partial", "decode_attention_partial_cuda",
           "decode_attention_partial_plain", "decode_attention_partial_ref"]
