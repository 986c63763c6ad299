from repro_torch.sampling.continuous import (ContinuousEngine,
                                             clamp_prefill_chunk,
                                             generate_continuous,
                                             rollout_from_results)
from repro_torch.sampling.engine import (StaticEngine, build_engine,
                                         generate, token_logps)
from repro_torch.sampling.paged_cache import (SCRATCH_PAGE, PageAllocator,
                                              init_paged_pool,
                                              new_block_table,
                                              paged_cache_supported,
                                              pages_for)
from repro_torch.sampling.prefix_cache import PrefixCache
from repro_torch.sampling.sample import (filter_logits, mask_vocab,
                                         model_logp, sample_token,
                                         sample_token_rows)
from repro_torch.sampling.scheduler import (DECODE, PREFILL,
                                            ContinuousScheduler, GenRequest)
from repro_torch.sampling.spec import (DraftProposer, NGramDrafter,
                                       accept_drafts, fused_rescore_diff,
                                       stacked_pools, verify_width_buckets)

__all__ = ["ContinuousEngine", "clamp_prefill_chunk", "generate_continuous",
           "rollout_from_results", "StaticEngine", "build_engine",
           "generate", "token_logps",
           "SCRATCH_PAGE", "PageAllocator", "init_paged_pool",
           "new_block_table", "paged_cache_supported", "pages_for",
           "PrefixCache", "filter_logits", "mask_vocab", "model_logp",
           "sample_token", "sample_token_rows", "DECODE", "PREFILL", "ContinuousScheduler",
           "GenRequest", "DraftProposer", "NGramDrafter", "accept_drafts",
           "fused_rescore_diff", "stacked_pools", "verify_width_buckets"]
