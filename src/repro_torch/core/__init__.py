"""The paper's algorithmic core in PyTorch: token log-probs, group
advantages, importance weights (token / sequence / group level), the loss
of every method and the stability diagnostics."""
from repro_torch.core.advantage import group_advantages
from repro_torch.core.importance import (ALL_METHODS,
                                         group_expectation_log_denominator,
                                         importance_weights, seq_logprob)
from repro_torch.core.loss import kl_k3, policy_loss

__all__ = ["group_advantages", "importance_weights", "policy_loss",
           "kl_k3", "seq_logprob", "ALL_METHODS",
           "group_expectation_log_denominator"]
