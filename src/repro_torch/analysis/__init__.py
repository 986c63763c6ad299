"""repro_torch.analysis — the launch-shape sentinel (the runtime half of
the JAX package's ``repro.analysis``; its static linter already scans
this package).
"""
from repro_torch.analysis.sentinel import (RecompileSentinel,
                                           executable_bound,
                                           install_metrics_listener,
                                           pow2_bucket_count,
                                           prefill_executable_bound,
                                           record_launch,
                                           spec_verify_executable_bound,
                                           spec_verify_width_buckets)

__all__ = ["RecompileSentinel", "executable_bound", "pow2_bucket_count",
           "prefill_executable_bound", "spec_verify_width_buckets",
           "spec_verify_executable_bound", "install_metrics_listener",
           "record_launch"]
