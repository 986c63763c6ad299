"""Back-compat shim: logical-axis -> mesh-axis resolution lives in
``repro_torch.parallel.axes``; running code consumes it through
``repro_torch.parallel.ExecutionPlan`` rather than resolving specs by
hand."""
from repro_torch.parallel.axes import (MODES,  # noqa: F401
                                       act_sharding_for, batch_specs,
                                       cache_specs, fit_spec, opt_specs,
                                       param_specs, resolve_spec, to_named,
                                       to_named_fit)

__all__ = ["MODES", "resolve_spec", "param_specs", "opt_specs",
           "batch_specs", "cache_specs", "act_sharding_for", "to_named",
           "fit_spec", "to_named_fit"]
