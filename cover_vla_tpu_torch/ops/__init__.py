from cover_vla_tpu_torch.ops.norms import rms_norm, layer_norm
from cover_vla_tpu_torch.ops.rope import apply_rope
from cover_vla_tpu_torch.ops.masks import (
    make_att_2d_masks, prefix_att_masks, suffix_att_masks)
from cover_vla_tpu_torch.ops.attention import (
    gqa_attention, mha_attention, BIG_NEG)
from cover_vla_tpu_torch.ops.image import (
    resize_bilinear_torch, resize_lanczos4, resize_bicubic_pil,
    resize_with_pad, to_siglip_range, patchify)
from cover_vla_tpu_torch.ops.sampling import (
    sinusoidal_time_embedding, sample_beta, sample_flow_time, sample_noise)
