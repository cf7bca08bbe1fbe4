"""Planners of the port: the cost model, the survey's paradigm planners
and the early-exit helpers (copies of the reference package's
framework-free ``core/`` modules)."""
from repro_torch.core.cost_model import (TABLE2, LINKS, TPU_V5E, CostGraph,
                                         DeviceProfile, LinkProfile,
                                         build_cost_graph,
                                         kv_cache_bytes_per_token)
from repro_torch.core.paradigms import (AdmissionDecision, CollaborationPlan,
                                        Scenario, TierOutage,
                                        admission_decision, plan_all,
                                        plan_cloud_device, plan_edge_device,
                                        plan_cloud_edge_device,
                                        plan_device_device)

__all__ = [
    "TABLE2", "LINKS", "TPU_V5E", "CostGraph", "DeviceProfile", "LinkProfile",
    "build_cost_graph", "kv_cache_bytes_per_token", "AdmissionDecision",
    "CollaborationPlan", "Scenario", "TierOutage", "admission_decision",
    "plan_all", "plan_cloud_device", "plan_edge_device",
    "plan_cloud_edge_device", "plan_device_device",
]
