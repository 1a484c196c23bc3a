from .ops import decode_attention, flash_attention
from .kernel import flash_attention_bwd_cuda, flash_attention_cuda
from .ref import (decode_attention_ref, flash_attention_bwd_ref,
                  flash_attention_ref)

__all__ = ["decode_attention", "decode_attention_ref", "flash_attention",
           "flash_attention_bwd_cuda", "flash_attention_bwd_ref",
           "flash_attention_cuda", "flash_attention_ref"]
