"""Model base class, registry and checkpoint interchange for the PyTorch
port (counterpart of ``tdanet_tpu/models/base.py``).

A model is an ``nn.Module`` whose ``state_dict()`` keys equal the JAX
package's flat parameter keys, which are the reference torch module paths.
Checkpoints use the reference schema ``{model_name, state_dict,
model_args, infos}``, so a ``.pth`` written by either package loads in the
other.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from tdanet_tpu_torch.models.components import GlobLN
from tdanet_tpu_torch.ops import basic as ops

_MODEL_REGISTRY: Dict[str, type] = {}

# the positional-encoding buffer of reference checkpoints: the port
# recomputes it instead of loading it
_SKIP_SUFFIX = ".pe"


def register_model(cls=None, *, name: str | None = None):
    """Register a model class under its case-insensitive name."""
    def wrap(c):
        _MODEL_REGISTRY[(name or c.__name__).lower()] = c
        return c
    return wrap(cls) if cls is not None else wrap


def get(identifier):
    """Resolve a model class from its name (or return a class as is)."""
    if isinstance(identifier, type):
        return identifier
    if isinstance(identifier, str):
        cls = _MODEL_REGISTRY.get(identifier.lower())
        if cls is None:
            raise ValueError(
                f"Could not resolve model name {identifier!r}. Registered: "
                f"{sorted(_MODEL_REGISTRY)}")
        return cls
    raise ValueError(f"Invalid model identifier {identifier!r}")


def warn_unused_kwargs(cls_name: str, unused: Dict[str, Any]):
    """Warn about constructor kwargs a model ignores. ``n_src`` is exempt:
    reference checkpoints serialize it and no constructor takes it."""
    unused = {k: v for k, v in unused.items() if k != "n_src"}
    if unused:
        import warnings
        warnings.warn(
            f"{cls_name} ignoring unknown kwargs {sorted(unused)} — "
            "check the audionet_config key names", stacklevel=3)


def flat_to_state_dict(flat: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flat ``{dotted_key: array}`` -> torch state dict, dtypes kept.
    Drops the positional-encoding buffer, which the port recomputes."""
    return {k: v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
            for k, v in flat.items() if not k.endswith(_SKIP_SUFFIX)}


def strip_prefix(state: Dict[str, Any], prefix="audio_model."):
    """Lightning checkpoints prefix the model weights with 'audio_model.'."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in state.items()}


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Read a reference-format .pth/.bin ({model_name, state_dict,
    model_args, infos}) or a raw state dict, on the CPU."""
    conf = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" not in conf:
        conf = {"model_name": None, "state_dict": conf, "model_args": {}}
    conf["state_dict"] = strip_prefix(dict(conf["state_dict"]))
    return conf


def load_jax_params(module: nn.Module, flat: Dict[str, Any]) -> nn.Module:
    """Copy a flat ``{dotted_key: array}`` parameter dict (the JAX
    package's ``pytree_to_flat_torch`` output, or the state dict of a .pth
    it exported) into ``module`` with ``load_state_dict(strict=True)``.
    The module keeps its own dtypes and device."""
    module.load_state_dict(flat_to_state_dict(flat), strict=True)
    return module


@torch.no_grad()
def init_parameters_(module: nn.Module, generator: torch.Generator):
    """Initialise every parameter of ``module`` from ``generator`` with the
    distributions of the JAX package's init helpers: torch-default convs,
    unit gains and zero shifts for the norms, 0.25 PReLU slopes, xavier
    attention input projections. Returns ``module``."""
    for m in module.modules():
        if isinstance(m, nn.Conv1d):
            ops.conv1d_init_(m, generator)
        elif isinstance(m, nn.MultiheadAttention):
            ops.mha_init_(m, generator)
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, GlobLN):
            m.gamma.fill_(1.0)
            m.beta.zero_()
    return module


class BaseModel(nn.Module):
    """A separation model: ``forward(wav) -> estimates``."""

    def __init__(self, sample_rate):
        super().__init__()
        self._sample_rate = sample_rate

    def sample_rate(self):
        return self._sample_rate

    def get_model_args(self) -> Dict[str, Any]:
        raise NotImplementedError

    def reset_parameters(self, generator: torch.Generator):
        """Initialise every parameter from ``generator`` (see
        :func:`init_parameters_`)."""
        return init_parameters_(self, generator)

    def serialize(self) -> Dict[str, Any]:
        """Portable export in the reference schema."""
        import tdanet_tpu_torch
        return {
            "model_name": type(self).__name__,
            "state_dict": {k: v.detach().cpu()
                           for k, v in self.state_dict().items()},
            "model_args": self.get_model_args(),
            "infos": {"software_versions": {
                "tdanet_tpu_torch_version": tdanet_tpu_torch.__version__,
                # a plain str: weights-only loading refuses TorchVersion
                "torch_version": str(torch.__version__),
            }},
        }

    @staticmethod
    def from_pretrain(model_name_or_path, pretrained_model_conf_or_path=None,
                      **kwargs):
        """Build a model from a reference-format checkpoint on disk.

        ``model_name_or_path`` names a registered model (the checkpoint is
        then ``pretrained_model_conf_or_path``) or is the checkpoint path,
        whose embedded ``model_name`` is used. The model is returned on the
        CPU; move it with ``.to(device)``."""
        path = pretrained_model_conf_or_path or model_name_or_path
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no checkpoint at {path!r}; tdanet_tpu_torch does not fetch "
                "from a model hub, so pass a local checkpoint path")
        conf = load_torch_checkpoint(path)
        name = (model_name_or_path
                if isinstance(model_name_or_path, str)
                and model_name_or_path.lower() in _MODEL_REGISTRY
                else conf.get("model_name"))
        model = get(name)(**{**conf.get("model_args", {}), **kwargs})
        return load_jax_params(model, conf["state_dict"]).eval()
