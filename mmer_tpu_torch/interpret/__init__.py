"""Feature-importance interpretability (Integrated Gradients in PyTorch)."""
