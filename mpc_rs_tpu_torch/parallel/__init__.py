"""Scenario-batched closed loops (the fleet)."""
