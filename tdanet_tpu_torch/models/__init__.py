from tdanet_tpu_torch.models.base import (  # noqa: F401
    BaseModel, flat_to_state_dict, get,
    load_jax_params, load_torch_checkpoint, register_model, strip_prefix)
from tdanet_tpu_torch.models.tdanet_best import TDANetBest  # noqa: F401
from tdanet_tpu_torch.models import swin  # noqa: F401,E402
from tdanet_tpu_torch.models.swin import (  # noqa: F401,E402
    SwinTransformer, SwinTransformerSys, SwinTransformerSysCustom)
