"""cover_vla_tpu_torch — the PyTorch/CUDA port of cover_vla_tpu for one
NVIDIA H100.

The same modules and function names as the JAX package, in PyTorch:
parameters in the same layout (`models/params.ParamTree`), an explicit
device at every entry point (CUDA unless the caller passes another), and
hand-written Hopper kernels in `csrc/` where the JAX package had Pallas
kernels (`ops/cuda_attention.py`). Ported so far: the episode-batched
verified control step (`engine/verified_step.py`), the closed-loop
evaluation path over it (`engine/cover_engine.py`,
`engine/batched_engine.py`, `eval/evaluator.py` and the fake environment,
adapters and tokenizers they need), and the serving path: int8 (w8a8)
serving (`ops/quant.py`), pi0-FAST (`models/pi0fast.py`), the policy
wrappers and websocket server (`serving/`), the policy factory
(`models/factory.py`) and remote evaluation
(`eval/remote_evaluator.py`); checkpoint conversion and loading
(`convert/`: lerobot π0 / π0-FAST and merged verifier checkpoints, the
blob checkpoint format, the convert-once cache) behind the wrappers'
`switch_model`, and the `run.py` entry point (`serve_policy`, `eval`).
"""
