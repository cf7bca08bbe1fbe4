"""Early-exit runtime helpers of the port."""
