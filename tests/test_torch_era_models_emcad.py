"""The EMCAD-era family against the JAX package, first part: the flagship
TDANetEMCADv1_6 and the models over the full EMCAD decoders (v1, v1_3,
v1_5, TDANetEMCAD, TDANetEMCADF1, the FCDyConv pair), in float64 on the
same perturbed weights of the JAX init: out 64, in 128, 1 block, depth 5,
4 ms at 8 kHz, B=2, T 1000, feat_len 134. The JAX forward runs under jit
(eagerly its grouped convs take tens of seconds). The v1_6 ablations are
in ``test_torch_era_models_ablations.py``, the TransXNet-flavoured models
and TDANetEMCADv1_6's gradient in ``test_torch_era_models_transxnet.py``,
the registry, the keys, the checkpoints and the routing in
``test_torch_era_registry.py``."""
import pytest
import torch

from torch_port_helpers import check_era_forward

jax = pytest.importorskip("jax")

NAMES = ["TDANetEMCADv1_6", "TDANetEMCAD_v1", "TDANetEMCADv1_3",
         "TDANetEMCADv1_5", "TDANetEMCAD", "TDANetEMCADF1",
         "TDANetEMCADv1_6_Final", "TDANetEMCADv1_6_FCDyConv"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax_fp64(name):
    check_era_forward(name, seed=NAMES.index(name))
