"""Scenario-parallel execution over ``torch.distributed`` (``mesh``)."""
