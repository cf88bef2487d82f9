"""cover_vla_tpu_torch — the PyTorch/CUDA port of cover_vla_tpu for one
NVIDIA H100.

The same modules and function names as the JAX package, in PyTorch:
parameters in the same layout (`models/params.ParamTree`), an explicit
device at every entry point (CUDA unless the caller passes another), and
hand-written Hopper kernels in `csrc/` where the JAX package had Pallas
kernels (`ops/cuda_attention.py`).

Every module of the JAX package has a counterpart: the episode-batched
verified control step (`engine/verified_step.py`) and the closed-loop
evaluation path over it (`engine/`, `eval/`), int8 serving, π0-FAST, the
policy wrappers and the websocket server (`serving/`), checkpoint
conversion and loading (`convert/`), π0, π0-FAST and verifier training
(`training/`, `data/`), the multi-process paths (`parallel/`), the
`run.py` entry point with its roles and the bench program (`bench.py`).
`scripts/torch_verification_scaling.py` runs the verification-scaling
experiment's evaluation grid on it, with the committed trained trees.
Importing the package builds no kernel: the kernels are compiled and
loaded at their first launch (`_build.py`).
"""

__version__ = "0.1.0"
