"""The benchmark's plain reference: float32 PyTorch, no program code, no JAX."""
