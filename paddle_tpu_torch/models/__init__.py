from .convert import state_dict_from_paddle_tpu, state_dict_to_paddle_tpu
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel,
                    LlamaPretrainingCriterion, count_params, flops_per_token)

__all__ = ["LlamaAttention", "LlamaConfig", "LlamaDecoderLayer",
           "LlamaForCausalLM", "LlamaMLP", "LlamaModel",
           "LlamaPretrainingCriterion", "count_params", "flops_per_token",
           "state_dict_from_paddle_tpu", "state_dict_to_paddle_tpu"]
