"""Serving runtime of the port: paged KV arena and the single-pool
continuous-batching scheduler."""
from repro_torch.serving.scheduler import (ContinuousBatchScheduler, Request,
                                           SchedulerConfig, StepReport)

__all__ = ["ContinuousBatchScheduler", "Request", "SchedulerConfig",
           "StepReport"]
