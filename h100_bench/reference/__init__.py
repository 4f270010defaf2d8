"""The plain reference: GRL and its training steps in float32 PyTorch."""
