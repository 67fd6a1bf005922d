"""The port's meshes (``tdanet_tpu_torch/parallel/mesh.py``) against the
JAX package's (``tdanet_tpu/parallel/mesh.py``): mesh shapes and errors,
the batch check of dp-split eval and serving, the tp layout table as
per-parameter spec strings for every TDANetBest parameter at tp 1, 2 and 3
(the same dropped set), the refusals of tp execution, and the launcher's
rank commands. No process group is started here: those paths run in the
subprocess tests (``test_torch_parallel_step.py``,
``test_torch_parallel_trainer.py``)."""
import warnings

import pytest
import torch

jax = pytest.importorskip("jax")

from tdanet_tpu_torch import launch_multihost  # noqa: E402
from tdanet_tpu_torch.parallel import (  # noqa: E402
    batch_sharding, dp_batch_setup, initialize_distributed, make_mesh,
    param_shardings, replicated, shard_params)
from tdanet_tpu_torch.parallel import collectives  # noqa: E402

FULL = dict(out_channels=128, in_channels=512, num_blocks=16,
            upsampling_depth=5, enc_kernel_size=4, num_sources=2,
            sample_rate=8000)


def test_local_mesh_shapes_and_errors(monkeypatch):
    mesh = make_mesh(dp=2, devices=["cpu", "cpu"])
    assert mesh.shape == {"dp": 2, "tp": 1} and mesh.dp == 2
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert not mesh.across_processes and mesh.rank == 0
    assert make_mesh(devices=["cpu"] * 3).dp == 3
    # dp * tp must equal the devices, with the JAX package's message
    with pytest.raises(AssertionError, match=r"dp\(2\) \* tp\(1\) != "
                                             r"devices\(3\)"):
        make_mesh(dp=2, devices=["cpu"] * 3)
    # no list: only the visible cards count, and there are none here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="visible CUDA device"):
        make_mesh(dp=2)
    # tp execution is not ported
    for call in (lambda: make_mesh(dp=1, tp=2, devices=["cpu"] * 2),
                 lambda: shard_params({}, {"dp": 1, "tp": 2})):
        with pytest.raises(NotImplementedError, match="ROADMAP A #10"):
            call()


def test_batch_check_and_rows_match_the_jax_contract():
    from tdanet_tpu.parallel.mesh import dp_batch_setup as jsetup
    from tdanet_tpu.parallel.mesh import make_mesh as jmake
    mesh = make_mesh(devices=["cpu", "cpu"])
    model = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError) as got:
        dp_batch_setup(mesh, 3, model, what="max_batch")
    with pytest.raises(ValueError) as want:
        jsetup(jmake(dp=2, tp=1, devices=jax.devices()[:2]), 3, {},
               what="max_batch")
    assert str(got.value) == str(want.value)
    rows, reps = dp_batch_setup(mesh, 8, model)
    assert rows == batch_sharding(mesh, 8) == [slice(0, 4), slice(4, 8)]
    # a repeated device shares its replica: nothing is copied
    assert reps[0] is reps[1] is model
    assert replicated(mesh, model) == [model, model]


def _flat(tree, prefix=""):
    """A nested dict's leaves under their dotted paths."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    return out


@pytest.mark.parametrize("tp", [1, 2, 3])
def test_param_shardings_match_jax_for_every_parameter(tp):
    """The full-width TDANetBest: every parameter's spec string equals
    ``str(NamedSharding.spec)`` of the JAX package's param_shardings on a
    (1, tp) mesh, and the same rules drop to replication (the warning's
    count)."""
    from tdanet_tpu.models import TDANetBest as JBest
    from tdanet_tpu.parallel.mesh import make_mesh as jmake
    from tdanet_tpu.parallel.mesh import param_shardings as jshard
    from tdanet_tpu_torch.models import TDANetBest

    shapes = jax.eval_shape(JBest(**FULL).init, jax.random.PRNGKey(0))
    jmesh = jmake(dp=1, tp=tp, devices=jax.devices()[:tp])
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = {k: str(v.spec)
                for k, v in _flat(jshard(shapes, jmesh)).items()}
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = param_shardings(TDANetBest(**FULL), {"dp": 1, "tp": tp})
    assert got == want
    # one warning each, with the same count (both list the first five
    # drops, in their own parameter order)
    assert [str(w.message).split(":")[1] for w in tw] == \
        [str(w.message).split(":")[1] for w in jw]
    if tp == 3:  # 512 % 3: the rules drop
        assert tw and "dropped to replication" in str(tw[0].message)
    if tp == 2:
        assert any("'tp'" in v for v in got.values()) and not tw


def test_one_process_starts_no_group(monkeypatch):
    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed(num_processes=1, process_id=0) is False
    assert not torch.distributed.is_initialized()
    x = torch.arange(6.0).reshape(3, 2)
    # without a group every collective is the identity
    assert collectives.gather_rows(x, None) is x
    assert collectives.global_sum(x, None) is x
    assert collectives.any_rank([True, False], None) == (True, False)
    assert collectives.rank_rows(x, None) is x
    assert collectives.global_shape((3, 2), None) == (3, 2)


def test_launcher_builds_each_ranks_command_and_environment():
    cmd = launch_multihost.child_command(["audio_train", "--conf_dir", "c"],
                                         "cpu")
    assert cmd[1:] == ["-m", "tdanet_tpu_torch.audio_train", "--conf_dir",
                       "c", "--device", "cpu"]
    assert launch_multihost.child_command(["x.py", "a"])[1:] == ["x.py", "a"]
    env = launch_multihost.rank_env("127.0.0.1", 1234, 2, 1, 1, "gloo")
    assert (env["MASTER_ADDR"], env["MASTER_PORT"], env["WORLD_SIZE"],
            env["RANK"], env["LOCAL_RANK"], env["TDANET_DIST_BACKEND"]) == (
        "127.0.0.1", "1234", "2", "1", "1", "gloo")
    with pytest.raises(SystemExit):
        launch_multihost.main(["--nprocs", "2", "--cpu", "--device",
                               "cuda:0", "--", "audio_train"])
    with pytest.raises(SystemExit):
        launch_multihost.main(["--nprocs", "2"])
    with pytest.raises(SystemExit):
        launch_multihost.main(["--", "audio_train"])
