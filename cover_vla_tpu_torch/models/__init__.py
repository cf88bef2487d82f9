from cover_vla_tpu_torch.models import gemma, siglip
from cover_vla_tpu_torch.models import pi0
