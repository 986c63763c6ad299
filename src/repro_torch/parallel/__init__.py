"""The sharded execution layer (the port of ``repro/parallel``).

Logical-axis rules (``axes``) and rank meshes (``mesh``) feed an
``ExecutionPlan`` (``plan``) that the learner's train and SFT steps
(``step``), the checkpoint publisher and subscriber, and the HeteroRL
learner node consume for placement. Meshes are built on
``torch.distributed``; the 1x1 local mesh needs no process group.
"""
from repro_torch.parallel.mesh import (HBM_BW, ICI_BW, PEAK_BF16_FLOPS,
                                       abstract_mesh, data_axes, local_mesh,
                                       make_debug_mesh, make_mesh,
                                       make_production_mesh, mesh_from_flag)
from repro_torch.parallel.plan import (ExecutionPlan, local_plan, make_plan,
                                       plan_for_params, plan_from_flag)
from repro_torch.parallel.step import (make_sharded_sft_step,
                                       make_sharded_train_step)

__all__ = [
    "ExecutionPlan", "make_plan", "local_plan", "plan_from_flag",
    "plan_for_params",
    "make_sharded_train_step", "make_sharded_sft_step",
    "make_production_mesh", "make_debug_mesh", "make_mesh", "local_mesh",
    "abstract_mesh", "mesh_from_flag", "data_axes",
    "PEAK_BF16_FLOPS", "HBM_BW", "ICI_BW",
]
