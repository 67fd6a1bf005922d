"""The port's counterparts of ``tests/test_multihost.py``: two ranks over
gloo on the CPU, each a subprocess (``tests/torch_parallel_worker.py``,
or the launcher's children), on one torch thread each:

- a 2-rank train step whose ranks return the same (global) loss;
- a step failure on every rank at the same batch: every rank restores the
  last checkpoint in the same iteration and the two finish in lockstep;
- SIGTERM on rank 0 only: both ranks stop at the same batch and rank 0
  writes the checkpoint;
- ``python -m tdanet_tpu_torch.launch_multihost --nprocs 2 --cpu --
  audio_train``: one best_model.pth and a finite history, equal on both
  ranks.
"""
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from torch_port_helpers import run_ranks

from tdanet_tpu_torch.launch_multihost import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = "tests/torch_parallel_worker.py"
CFG = dict(out_channels=16, in_channels=32, num_blocks=1,
           upsampling_depth=3, enc_kernel_size=4, num_sources=2,
           sample_rate=8000)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """8 training and 4 validation utterances of 1.2 s at 8 kHz."""
    from tdanet_tpu_torch.probes.train_step import write_split
    root = tmp_path_factory.mktemp("dp_data")
    write_split(str(root / "tr"), 8, seed=0, seconds=1.2)
    write_split(str(root / "cv"), 4, seed=1, seconds=1.2)
    return root


def test_two_rank_step_gives_equal_losses(tmp_path):
    import numpy as np
    rng = np.random.default_rng(0)
    src = 0.1 * rng.standard_normal((4, 2, 2000))
    spec = {"name": "TDANetBest", "cfg": CFG, "flat": None,
            "mix": src.sum(1), "src": src, "training": True, "seed": 3}
    torch.save(spec, tmp_path / "spec.pt")
    port = free_port()
    outs = run_ranks([[WORKER, "step", str(tmp_path / "spec.pt"), str(port),
                       str(r), "2", str(tmp_path / f"r{r}.pt")]
                      for r in (0, 1)])
    losses = [float(re.search(r"RANK \d LOSS (\S+)", o).group(1))
              for o in outs]
    assert math.isfinite(losses[0]) and losses[0] == losses[1], losses


def _trainers(data, tmp_path, mode):
    port = free_port()
    exp = str(tmp_path / "exp")
    return run_ranks([[WORKER, "trainer", str(port), str(r), "2", str(data),
                       exp, mode] for r in (0, 1)], timeout=300), exp


def test_step_failure_recovery_synchronized_across_ranks(data, tmp_path):
    """Every rank's second step raises (as a failing collective does on
    every participant): both ranks restore in the same iteration, finish
    both epochs with the same step count and the same validation loss."""
    outs, _ = _trainers(data, tmp_path, "fail")
    assert "restoring the last checkpoint on every rank" in outs[0]
    finals = [re.search(r"RANK \d EPOCHS (\d+) steps=(\d+) VAL (\S+)",
                        o).groups() for o in outs]
    assert finals[0] == finals[1] and finals[0][0] == "2", finals


def test_preemption_on_one_rank_propagates_to_all(data, tmp_path):
    """SIGTERM reaches rank 0 alone, at its second step: the flag is OR-ed
    over ranks at the batch boundary, so both break out of the first epoch
    after the same step and rank 0 writes the preemption checkpoint."""
    outs, exp = _trainers(data, tmp_path, "preempt")
    got = [re.search(r"RANK \d PREEMPT_OK epochs=(\d+) steps=(\d+) "
                     r"last_ckpt=(\w+)", o).groups() for o in outs]
    assert got[0] == got[1] == ("0", "2", "True"), got
    assert os.listdir(os.path.join(exp, "last"))


def test_launcher_runs_audio_train_on_two_ranks(data, tmp_path):
    exp = tmp_path / "exp"
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    argv = [sys.executable, "-m", "tdanet_tpu_torch.launch_multihost",
            "--nprocs", "2", "--cpu", "--timeout", "300", "--",
            "audio_train", "--conf_dir", "configs/tdanet_debug.yml",
            f"datamodule.data_config.train_dir={data / 'tr'}",
            f"datamodule.data_config.valid_dir={data / 'cv'}",
            f"datamodule.data_config.test_dir={data / 'cv'}",
            "datamodule.data_config.batch_size=4",
            "datamodule.data_config.num_workers=0",
            *(f"audionet.audionet_config.{k}={v}" for k, v in CFG.items()
              if k != "sample_rate"),
            "training.epochs=1", f"main_args.exp_dir={exp}",
            "exp.disable_wandb=true"]
    out = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=360)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "history rows equal on 2 ranks" in out.stdout
    assert out.stdout.count("Exported best_model.pth") == 1
    assert os.path.exists(exp / "best_model.pth")
    hist = json.loads((exp / "history.json").read_text())
    assert len(hist) == 1 and math.isfinite(hist[0]["val_loss"])
    # a failing rank fails the launcher, which stops the other rank
    bad = subprocess.run(argv[:argv.index("--conf_dir")]
                         + ["--conf_dir", str(tmp_path / "missing.yml")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert bad.returncode != 0
