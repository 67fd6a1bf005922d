"""The EMCAD-era family against the JAX package, second part: the
ablations of TDANetEMCADv1_6 (the conv pyramid in place of IDConv; no
gate, no CBAM, no MSCB; the LAOpt1, 3, 4 and 5 last layers), in float64
on the same perturbed weights of the JAX init, at the sizes of
``test_torch_era_models_emcad.py``."""
import pytest
import torch

from torch_port_helpers import check_era_forward

jax = pytest.importorskip("jax")

NAMES = ["TDANetEMCADv1_6_noIDConv", "TDANetEMCADv1_6_LAOpt1",
         "TDANetEMCADv1_6_noASG", "TDANetEMCADv1_6_noCBAM",
         "TDANetEMCADv1_6_noMMLP", "TDANetEMCADv1_6_noCBAM_laopt3",
         "TDANetEMCADv1_6_noCBAM_laopt4", "TDANetEMCADv1_6_noCBAM_laopt5"]


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
    check_era_forward(name, seed=20 + NAMES.index(name))
