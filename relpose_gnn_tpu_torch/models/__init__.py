"""PyTorch modules of the relocalization model."""
