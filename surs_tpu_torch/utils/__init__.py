"""Utilities: the synthetic humanoid subject and the mesh-fidelity
metrics."""
