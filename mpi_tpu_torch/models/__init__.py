"""The flagship decoder LM's serving slice: config, parameters, forward,
KV-cache generation, int8 weights, and loading the JAX package's tree."""

from .convert import params_from_jax
from .generate import decode_step, generate, prefill
from .quant import QTensor, dequantize, quantize, quantize_params
from .transformer import TransformerConfig, forward, init_params

__all__ = ["TransformerConfig", "init_params", "forward", "prefill",
           "decode_step", "generate", "QTensor", "quantize", "dequantize",
           "quantize_params", "params_from_jax"]
