"""Training: optimizers, train/eval steps and checkpoints."""
