"""Kernels of the port: the dense attention oracle, flash attention
(forward and FA-2 backward kernels), the flash-decode kernel and the ring
collectives (all-gather and all-reduce kernels)."""

from .attention import (NEG_INF, dense_attention, flash_attention,
                        flash_attention_bwd_plain, flash_attention_fwd_plain,
                        flash_attention_with_lse, flash_bwd_dkv, flash_bwd_dq,
                        flash_bwd_dq_delta, flash_chunk_bwd, flash_fwd)
from .decode_attention import (flash_decode_attention,
                               flash_decode_attention_plain)
from .ring_collectives import (ring_allgather, ring_allgather_plain,
                               ring_allgather_sharded, ring_allreduce,
                               ring_allreduce_plain, ring_allreduce_sharded)

__all__ = ["NEG_INF", "dense_attention", "flash_attention",
           "flash_attention_with_lse", "flash_chunk_bwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_plain",
           "flash_fwd", "flash_bwd_dq", "flash_bwd_dq_delta", "flash_bwd_dkv",
           "flash_decode_attention", "flash_decode_attention_plain",
           "ring_allgather", "ring_allgather_sharded", "ring_allgather_plain",
           "ring_allreduce", "ring_allreduce_sharded", "ring_allreduce_plain"]
