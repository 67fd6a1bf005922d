from tdanet_tpu_torch.utils.audio_io import (  # noqa: F401
    read_wav, wav_frames, write_wav)
from tdanet_tpu_torch.utils.separator import (  # noqa: F401
    plan_lattice_buckets, separate, separate_batched, trim_renorm)
