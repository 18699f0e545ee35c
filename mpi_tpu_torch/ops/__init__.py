"""Attention ops of the port: the dense oracle and the flash-decode kernel."""

from .attention import NEG_INF, dense_attention
from .decode_attention import (flash_decode_attention,
                               flash_decode_attention_plain)

__all__ = ["NEG_INF", "dense_attention", "flash_decode_attention",
           "flash_decode_attention_plain"]
