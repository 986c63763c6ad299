"""repro_torch.analysis — the port's static analysis (RA001–RA005 in
torch's terms) and the launch-shape sentinel.

Run as ``python -m repro_torch.analysis`` (the package, its tests and
``chip_smoke.py``). See README "Static analysis of the port" for the
rules, the ``# noqa: RAxxx`` convention and the baseline workflow
(``analysis_baseline_torch.json``).
"""
from repro_torch.analysis.core import (Finding, RepoContext, SourceFile,
                                       collect_files, load_baseline,
                                       run_analysis, run_rules,
                                       save_baseline)
from repro_torch.analysis.rules import (RULE_DOCS, default_rules,
                                        hot_function_at)
from repro_torch.analysis.sentinel import (RecompileSentinel,
                                           executable_bound,
                                           install_metrics_listener,
                                           pow2_bucket_count,
                                           prefill_executable_bound,
                                           record_launch,
                                           spec_verify_executable_bound,
                                           spec_verify_width_buckets)

__all__ = ["Finding", "RepoContext", "SourceFile", "collect_files",
           "load_baseline", "run_analysis", "run_rules", "save_baseline",
           "RULE_DOCS", "default_rules", "hot_function_at",
           "RecompileSentinel", "executable_bound", "pow2_bucket_count",
           "prefill_executable_bound", "spec_verify_width_buckets",
           "spec_verify_executable_bound", "install_metrics_listener",
           "record_launch"]
