from cover_vla_tpu_torch.serving import msgpack_numpy
from cover_vla_tpu_torch.serving.policy_service import (
    WebsocketPolicyServer, WebsocketPolicyClient, BasePolicy)
from cover_vla_tpu_torch.serving.policy_wrapper import (
    Pi0PolicyWrapper, CoVerPolicyWrapper)
