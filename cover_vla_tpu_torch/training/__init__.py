"""Training: optimizers, the pi0 trainer and validation."""
