"""``utils/profiling.py``: the MACs that ``FlopCounterMode`` counts over
one forward, against a hand count from the convolution and linear shapes
of a small TDANetBest (not against the JAX package's XLA cost analysis,
which also counts the elementwise work); the parameter count; and the
line ``audio_train`` prints."""
import pytest
import torch

from tdanet_tpu_torch.models import TDANetBest
from tdanet_tpu_torch.utils.profiling import (count_macs, count_params,
                                              profile_model)

CFG = dict(out_channels=16, in_channels=32, num_blocks=2,
           upsampling_depth=4, enc_kernel_size=4, num_sources=2,
           sample_rate=8000)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hand_macs(cfg, T, model):
    """TDANetBest's MACs at B=1, one per weight element and output
    position: a conv's C_out x T_out x C_in / groups x K, a linear's
    rows x in x out. The B=1 inference attention is out_proj(v_proj(x))
    at the coarsest scale."""
    Co, Ci = cfg["out_channels"], cfg["in_channels"]
    n, d = cfg["num_blocks"], cfg["upsampling_depth"]
    K, E = model.enc_kernel_size, model.enc_num_basis
    with torch.no_grad():
        L = model._front(torch.zeros(1, T))[0].shape[-1]  # frames
    Ts = [L]
    for _ in range(1, d):  # the K5 stride-2 pyramid
        Ts.append((Ts[-1] - 1) // 2 + 1)
    Tc = Ts[-1]
    front = E * L * K + Co * L * E  # encoder, bottleneck
    block = Ci * L * Co + sum(Ci * t * 5 for t in Ts)  # proj, pyramid
    block += 2 * Tc * Ci * Ci  # v_proj, out_proj
    block += 2 * Ci * Tc * Ci + 2 * Ci * Tc * 5 + Ci * Tc * 2 * Ci  # FFN
    block += sum(Ci * t + 2 * Ci * Tc for t in Ts)  # K1 fusions
    for i in range(d - 2, -1, -1):  # K5 expansion LAs
        t_g = Ts[i - 1] if i == d - 2 else Ts[i + 1]
        block += Ci * Ts[i] * 5 + 2 * Ci * t_g * 5
    block += Co * L * Ci  # res_conv
    concat = Co * L  # depthwise 1x1, from the second iteration
    back = 2 * E * L * Co + 2 * E * L * 2 * K  # mask head, decoder
    return front + n * block + (n - 1) * concat + back


@pytest.mark.parametrize("T", [8000, 5003])
def test_macs_equal_the_hand_count(T):
    model = TDANetBest(**CFG).eval()
    want = hand_macs(CFG, T, model)
    got = count_macs(model, torch.zeros(1, T))
    assert got == want
    # the meta copy counts what the CPU forward counts
    from torch.utils.flop_counter import FlopCounterMode
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.zeros(1, T))
    assert counter.get_total_flops() == 2 * got
    prof = profile_model(model, torch.zeros(1, T))
    assert prof == {"params": count_params(model), "flops": 2 * got,
                    "macs": got}
    assert count_params(model) == sum(
        p.numel() for p in model.state_dict().values())


def test_audio_train_prints_the_macs_a_segment():
    from tdanet_tpu_torch.audio_train import model_size
    model = TDANetBest(**CFG)
    config = {"audionet": {"audionet_name": "TDANetBest",
                           "audionet_config": CFG},
              "datamodule": {"data_config": {"sample_rate": 8000,
                                             "segment": 1.0}}}
    macs = hand_macs(CFG, 8000, model)
    assert model_size(model, config) == (
        f"{count_params(model) / 1e6:.2f}M params, "
        f"{macs / 1e9:.2f} GMACs/segment")
