"""Policy factory: name -> (config, initialiser, host wrapper)."""

from __future__ import annotations

from typing import Any


def make_policy(name: str, *, tiny: bool = False, params: Any = None,
                seed: int = 0, device=None, **kwargs):
    """Supported families: 'pi0' (flow matching, served through
    `Pi0PolicyWrapper`) and 'pi0fast' (autoregressive FAST tokens,
    `Pi0FastPolicy`), at full width or on their tiny configs. Without
    `params` the weights are random from `seed`. Everything lives on
    `device` (CUDA unless given); `kwargs` go to the wrapper. Both
    families run the Gemma backbone: `params` of π0 over an MLA + MoE
    backbone (`models/mla_moe.py`) are refused."""
    name = name.lower()
    if name == "pi0":
        from cover_vla_tpu_torch.configs import Pi0Config, tiny_pi0_config
        from cover_vla_tpu_torch.models import mla_moe, pi0
        from cover_vla_tpu_torch.serving.policy_wrapper import Pi0PolicyWrapper
        if params is not None and mla_moe.is_mla_moe(params["paligemma"]):
            raise NotImplementedError(
                "make_policy: the served π0 runs the Gemma backbone; these "
                "parameters are of an MLA + MoE backbone")
        cfg = tiny_pi0_config() if tiny else Pi0Config()
        if params is None:
            params = pi0.init_pi0(seed, cfg, device=device)
        return Pi0PolicyWrapper(params, cfg, device=device, **kwargs)
    if name == "pi0fast":
        from cover_vla_tpu_torch.models import pi0fast
        cfg = pi0fast.tiny_pi0fast_config() if tiny \
            else pi0fast.Pi0FastConfig()
        if params is None:
            params = pi0fast.init_pi0fast(seed, cfg, device=device)
        return pi0fast.Pi0FastPolicy(params, cfg, device=device, **kwargs)
    raise ValueError(f"unknown policy family {name!r} (pi0 | pi0fast)")
