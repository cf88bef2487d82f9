from cover_vla_tpu_torch.engine.verified_step import (
    make_verified_step, make_verified_step_batched, VerifiedStepResult)
from cover_vla_tpu_torch.engine.cover_engine import CoVerEngine, StepRecord
from cover_vla_tpu_torch.engine.batched_engine import (
    BatchedCoVerEngine, evaluate_batched)
