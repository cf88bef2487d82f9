from cover_vla_tpu_torch.eval.adapters import (
    BaseEnvAdapter, SimplerAdapter, BridgeSimplerAdapter,
    BridgeSimplerStickyGripperAdapter, ActionEnsembler,
    lanczos4_resize_uint8)
