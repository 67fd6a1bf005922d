"""The card's twins of ``chip_smoke.py`` phase 27 (a) and (b)
(``tdanet_tpu_torch/probes/dp_path.py``), at the recipe's full width: they
skip without a card. No JAX here; on the card:

    python -m pytest --noconftest tests/test_torch_parallel_gpu.py -m gpu
"""
import os

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tdanet_tpu_torch.probes import dp_path
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mix, src = dp_path.tone_batch(dp_path.B, seconds=dp_path.SECONDS,
                                  seed=dp_path.DATA)
    return (dp_path, mix, src) + dp_path.one_process_steps(mix, src)


@pytest.mark.gpu
def test_nccl_world1_step_equals_the_one_process_step(card):
    """(a): the step under an NCCL group of one rank against the step
    without a mesh, every gradient >= 100 dB, #1's launches 512 / 464."""
    dp_path, mix, src, reference, _ = card
    got = dp_path.drive_nccl_world1(mix, src, reference)
    assert got["min_grad_snr_db"] >= dp_path.GRAD_LIMIT_DB
    assert got["launches"] == [512, 464]


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_equal_one_process(card, tmp_path):
    """(b): two ranks on cuda:0 over gloo, 2 rows each: one loss, the same
    parameters bit for bit, every gradient >= 100 dB against the
    one-process step over the 4 rows at its activation sides, #1's
    launches 512 / 464 a rank."""
    dp_path, _, _, reference, pinned = card
    cwd = os.getcwd()
    os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        got = dp_path.drive_two_ranks(str(tmp_path), reference, pinned)
    finally:
        os.chdir(cwd)
    assert got["params_equal"]
    assert got["min_grad_snr_db"] >= dp_path.GRAD_LIMIT_DB
    assert got["launches_per_rank"] == [[512, 464], [512, 464]]
