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
from tdanet_tpu_torch.models import emcad, transxnet  # noqa: F401,E402
from tdanet_tpu_torch.models.tdanet_emcad import (  # noqa: F401,E402
    TDANetChannelFusion, TDANetDynamicDownsample, TDANetEMCAD,
    TDANetEMCAD_v1, TDANetEMCADF1, TDANetEMCADv1_3, TDANetEMCADv1_4,
    TDANetEMCADv1_5, TDANetEMCADv1_6, TDANetEMCADv1_6_FCDyConv,
    TDANetEMCADv1_6_Final, TDANetEMCADv1_6_LAOpt1, TDANetEMCADv1_6_noASG,
    TDANetEMCADv1_6_noCBAM, TDANetEMCADv1_6_noCBAM_laopt3,
    TDANetEMCADv1_6_noCBAM_laopt4, TDANetEMCADv1_6_noCBAM_laopt5,
    TDANetEMCADv1_6_noIDConv, TDANetEMCADv1_6_noMMLP, TDANetGateOSRA,
    TDANetMSFFN, TDANetTranXNet, feat_len_for, feat_len_ladder)
