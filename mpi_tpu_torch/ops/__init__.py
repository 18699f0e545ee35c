"""Attention ops of the port: the dense oracle, flash attention (forward
and FA-2 backward kernels) and the flash-decode kernel."""

from .attention import (NEG_INF, dense_attention, flash_attention,
                        flash_attention_bwd_plain, flash_attention_fwd_plain,
                        flash_attention_with_lse, flash_bwd_dkv, flash_bwd_dq,
                        flash_chunk_bwd, flash_fwd)
from .decode_attention import (flash_decode_attention,
                               flash_decode_attention_plain)

__all__ = ["NEG_INF", "dense_attention", "flash_attention",
           "flash_attention_with_lse", "flash_chunk_bwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_plain",
           "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_decode_attention", "flash_decode_attention_plain"]
