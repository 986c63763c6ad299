from repro_torch.serving.api import (GenerationResult, Request,
                                     SamplingParams, TokenEvent)

__all__ = ["GenerationResult", "Request", "SamplingParams", "TokenEvent"]
