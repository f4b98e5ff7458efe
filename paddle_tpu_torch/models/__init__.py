"""Model zoo of the port: GPT, Llama and BERT/ERNIE, single device."""
from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel, bert_base,
                   bert_large, bert_tiny, ernie_base)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion, gpt2_medium, gpt2_small, gpt_1p3b,
                  gpt_tiny, jax_state_dict, load_jax_state)
from .llama import (LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM,
                    LlamaModel, LlamaPretrainingCriterion, llama2_7b,
                    llama3_8b, llama_124m_gqa, llama_tiny)

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "bert_base",
           "bert_large", "bert_tiny", "ernie_base", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "GPTPretrainingCriterion", "gpt2_medium", "gpt2_small",
           "gpt_1p3b", "gpt_tiny", "jax_state_dict", "load_jax_state", "LlamaConfig",
           "LlamaDecoderLayer", "LlamaForCausalLM", "LlamaModel",
           "LlamaPretrainingCriterion", "llama2_7b", "llama3_8b",
           "llama_124m_gqa", "llama_tiny"]
