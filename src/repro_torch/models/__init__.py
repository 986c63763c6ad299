from repro_torch.models.model import decode_step, encode, forward, init_cache
from repro_torch.models.params import (init_params, param_templates,
                                       params_from_numpy)

__all__ = ["forward", "encode", "decode_step", "init_cache", "init_params",
           "param_templates", "params_from_numpy"]
