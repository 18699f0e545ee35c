"""The flagship decoder LM: config, parameters, forward, the next-token
loss and one training step on one device (AdamW, adafactor or sgd, at a
constant rate or on optax's schedules; its attention sequence parallel
over a rank mesh's ``sp`` axis, its batch data-parallel over the ``dp``
axis, with ZeRO-1 or FSDP as options, the model split over the ``tp``
axis), the same blocks as a GPipe pipeline over a ``pp`` axis
(:mod:`.pipeline_lm`), the Mixture-of-Experts FFN with its experts over
an ``ep`` axis (:mod:`.moe`), KV-cache generation with prompt-lookup
speculative decoding (:mod:`.speculative`), LoRA fine-tuning
(:mod:`.lora`), int8 weights, and loading the JAX package's tree; the
encoder family, the Vision Transformer over the same blocks
(:mod:`.vit`); and the state-space LM, served on one device and
sequence-parallel over an ``sp`` axis, and trained on one device and
data-parallel over a ``dp`` axis (:mod:`.ssm`)."""

from .convert import params_from_jax
from .generate import decode_step, generate, prefill
from .lora import (count_params, lora_delta, lora_from_jax, lora_init,
                   make_lora_train_parts, make_lora_train_step, merge_lora)
from .moe import init_moe_params, moe_ffn, moe_specs
from .pipeline_lm import (forward_pipelined, init_pipelined_params,
                          make_pipelined_train_step, pipeline_loss_fn,
                          stack_block_params)
from .quant import QTensor, dequantize, quantize, quantize_params
from .speculative import generate_lookahead
from .ssm import (SsmConfig, init_ssm_params, init_ssm_state,
                  make_ssm_train_step, ssm_decode, ssm_forward,
                  ssm_forward_sp, ssm_params_from_jax, ssm_prefill, ssm_step)
from .transformer import (TransformerConfig, forward, forward_with_aux,
                          full_params, init_params, loss_fn, make_mesh_nd,
                          make_optimizer, make_train_parts, make_train_step,
                          param_specs, rank_state, token_xent)
from .vit import (ViTConfig, forward_vit, init_vit_params,
                  make_vit_train_step, vit_loss_fn, vit_param_specs,
                  vit_params_from_jax)

__all__ = ["TransformerConfig", "init_params", "forward", "forward_with_aux",
           "token_xent", "loss_fn", "make_optimizer", "make_train_parts",
           "make_train_step", "full_params", "rank_state", "param_specs",
           "make_mesh_nd", "prefill", "decode_step", "generate",
           "generate_lookahead",
           "QTensor", "quantize", "dequantize", "quantize_params",
           "params_from_jax", "stack_block_params", "init_pipelined_params",
           "forward_pipelined", "pipeline_loss_fn",
           "make_pipelined_train_step", "init_moe_params", "moe_ffn",
           "moe_specs", "lora_init", "lora_delta", "merge_lora",
           "make_lora_train_parts", "make_lora_train_step", "count_params",
           "lora_from_jax", "ViTConfig", "init_vit_params", "forward_vit",
           "vit_loss_fn", "vit_param_specs", "make_vit_train_step",
           "vit_params_from_jax", "SsmConfig", "init_ssm_params",
           "ssm_forward", "ssm_forward_sp", "init_ssm_state", "ssm_step",
           "ssm_prefill", "ssm_decode", "make_ssm_train_step",
           "ssm_params_from_jax"]
