from cover_vla_tpu_torch.parallel.mesh import (
    make_mesh, fsdp_sharding, batch_sharding, replicated)
