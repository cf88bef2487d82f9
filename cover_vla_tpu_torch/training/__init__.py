"""Training: optimizers, the pi0 trainer and validation."""
from cover_vla_tpu_torch.training import optim, train_pi0, train_pi0fast
