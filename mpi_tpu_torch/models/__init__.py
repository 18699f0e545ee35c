"""The flagship decoder LM: config, parameters, forward, the next-token
loss and one AdamW training step on one device, KV-cache generation, int8
weights, and loading the JAX package's tree."""

from .convert import params_from_jax
from .generate import decode_step, generate, prefill
from .quant import QTensor, dequantize, quantize, quantize_params
from .transformer import (TransformerConfig, forward, forward_with_aux,
                          init_params, loss_fn, make_optimizer,
                          make_train_parts, make_train_step, token_xent)

__all__ = ["TransformerConfig", "init_params", "forward", "forward_with_aux",
           "token_xent", "loss_fn", "make_optimizer", "make_train_parts",
           "make_train_step", "prefill", "decode_step", "generate",
           "QTensor", "quantize", "dequantize", "quantize_params",
           "params_from_jax"]
