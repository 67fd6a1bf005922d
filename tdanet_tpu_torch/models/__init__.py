from tdanet_tpu_torch.models.base import (  # noqa: F401
    BaseModel, available_models, flat_to_state_dict, get,
    load_jax_params, load_torch_checkpoint, register_model, strip_prefix)
from tdanet_tpu_torch.models.tdanet_best import TDANetBest  # noqa: F401
from tdanet_tpu_torch.models.tdanet_variants import (  # noqa: F401
    TDANet, TDANetAttn, TDANetChunk, TDANetGateVariant, TDANetMultRes,
    TDANetNoDrop, TDANetOld, TDANetOrigin, TDANetULayerNum, TDANetV2,
    TDANetYang)
from tdanet_tpu_torch.models import swin  # noqa: F401,E402
from tdanet_tpu_torch.models.swin import (  # noqa: F401,E402
    SwinTransformer, SwinTransformerSys, SwinTransformerSysCustom)
