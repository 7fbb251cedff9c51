from .convert import state_dict_from_paddle_tpu, state_dict_to_paddle_tpu
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForCausalLM,
                  GPTForCausalLMPipe, GPTModel)
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel,
                    LlamaPretrainingCriterion, count_params, flops_per_token)

__all__ = ["GPTAttention", "GPTBlock", "GPTConfig", "GPTForCausalLM",
           "GPTForCausalLMPipe", "GPTModel", "LlamaAttention", "LlamaConfig",
           "LlamaDecoderLayer", "LlamaForCausalLM", "LlamaMLP", "LlamaModel",
           "LlamaPretrainingCriterion", "count_params", "flops_per_token",
           "state_dict_from_paddle_tpu", "state_dict_to_paddle_tpu"]
