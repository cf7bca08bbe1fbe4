"""Serving runtime of the port: the continuous-batching scheduler with its
paged KV arena, multi-model pools and speculative pairs, the admission
router and the tiered cloud/edge/device cluster."""
from repro_torch.serving.cluster import (ClusterConfig, ClusterRequest,
                                         TieredServingCluster,
                                         derive_tier_slots)
from repro_torch.serving.multipool import (ModelEntry, ModelGroup,
                                           MultiModelScheduler, SpecPair)
from repro_torch.serving.router import AdmissionRouter
from repro_torch.serving.scheduler import (ContinuousBatchScheduler, Request,
                                           SchedulerConfig, SlotSnapshot,
                                           StepReport)

__all__ = ["AdmissionRouter", "ClusterConfig", "ClusterRequest",
           "ContinuousBatchScheduler", "ModelEntry", "ModelGroup",
           "MultiModelScheduler", "Request", "SchedulerConfig",
           "SlotSnapshot", "SpecPair", "StepReport", "TieredServingCluster",
           "derive_tier_slots"]
