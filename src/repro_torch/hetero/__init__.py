from repro_torch.hetero.events import EventSim, Transport
from repro_torch.hetero.latency import DISTRIBUTIONS, sample_delay, sync_delay_s
from repro_torch.hetero.nodes import LearnerNode, RolloutBatch, SamplerNode
from repro_torch.hetero.runtime import HeteroRuntime, run_online
from repro_torch.hetero.threads import ThreadedHeteroRuntime

__all__ = ["EventSim", "Transport", "sample_delay", "sync_delay_s",
           "DISTRIBUTIONS", "LearnerNode", "SamplerNode", "RolloutBatch",
           "HeteroRuntime", "run_online", "ThreadedHeteroRuntime"]
