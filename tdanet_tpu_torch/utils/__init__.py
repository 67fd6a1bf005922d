from tdanet_tpu_torch.utils.audio_io import read_wav, write_wav  # noqa: F401
from tdanet_tpu_torch.utils.separator import (  # noqa: F401
    plan_lattice_buckets, separate, separate_batched, trim_renorm)
