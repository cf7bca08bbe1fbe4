"""Serving runtime of the port: the continuous-batching scheduler with its
paged KV arena, multi-model pools and speculative pairs, the admission
router, the tiered cloud/edge/device cluster, the batch front-end
(``ServingEngine``), adaptive exit control and the arrival traces."""
from repro_torch.serving.adaptive import AdaptiveExitController
from repro_torch.serving.cluster import (ClusterConfig, ClusterRequest,
                                         TieredServingCluster,
                                         derive_tier_slots)
from repro_torch.serving.engine import (ServeConfig, ServingEngine,
                                        make_serve_step,
                                        prime_whisper_cross_cache)
from repro_torch.serving.multipool import (ModelEntry, ModelGroup,
                                           MultiModelScheduler, SpecPair)
from repro_torch.serving.router import AdmissionRouter
from repro_torch.serving.scheduler import (ContinuousBatchScheduler, Request,
                                           SchedulerConfig, SlotSnapshot,
                                           StageSpec, StepReport)
from repro_torch.serving.traces import (diurnal_trace, flash_crowd_trace,
                                        make_trace, mixed_slo_trace,
                                        poisson_trace)

__all__ = ["AdaptiveExitController", "AdmissionRouter", "ClusterConfig",
           "ClusterRequest", "ContinuousBatchScheduler", "ModelEntry",
           "ModelGroup", "MultiModelScheduler", "Request", "SchedulerConfig",
           "ServeConfig", "ServingEngine", "SlotSnapshot", "SpecPair",
           "StageSpec", "StepReport", "TieredServingCluster", "derive_tier_slots",
           "diurnal_trace", "flash_crowd_trace", "make_serve_step",
           "make_trace", "mixed_slo_trace", "poisson_trace",
           "prime_whisper_cross_cache"]
