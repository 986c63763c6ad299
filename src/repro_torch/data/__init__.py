from repro_torch.data.pipeline import (PromptPipeline, RolloutRequest,
                                       score_rollouts)
from repro_torch.data.tasks import (BOS, EOS, PAD, ArithmeticTask, Problem,
                                    Tokenizer, encode_prompts)

__all__ = ["ArithmeticTask", "Tokenizer", "Problem", "encode_prompts",
           "PromptPipeline", "RolloutRequest", "score_rollouts",
           "PAD", "BOS", "EOS"]
