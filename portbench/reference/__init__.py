"""The plain reference: float32 PyTorch, nothing of the port."""
