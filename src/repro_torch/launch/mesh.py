"""Back-compat shim: meshes live in ``repro_torch.parallel.mesh`` (the
execution layer owns placement)."""
from repro_torch.parallel.mesh import (HBM_BW, ICI_BW,  # noqa: F401
                                       PEAK_BF16_FLOPS, data_axes,
                                       local_mesh, make_debug_mesh,
                                       make_production_mesh, mesh_from_flag)

__all__ = ["make_production_mesh", "make_debug_mesh", "local_mesh",
           "mesh_from_flag", "data_axes", "PEAK_BF16_FLOPS", "HBM_BW",
           "ICI_BW"]
