"""Placements over a mesh of ranks: the abstract mesh (axis names and
sizes, no devices) and the partition rules of parameters, optimizer
moments, batches and decode caches."""
