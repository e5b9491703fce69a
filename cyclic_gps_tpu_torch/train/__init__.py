"""Training: the loss, Adam with a reduce-on-plateau scale, checkpoints."""
