"""The port's deployment bundles (``tdanet_tpu_torch/deploy.py``) against
the JAX package's (``tdanet_tpu/deploy.py``) on the same weights, and the
behaviours of ``tests/test_deploy.py``, on the CPU.

The model is the JAX test's (width 32/64, 1 block, pyramid depth 4,
8 kHz). Both packages export for the CPU (``platforms=("cpu",)``,
``devices=("cpu",)``) in fp32; on the CPU a program's #1 nodes run the
plain version. The bundles are exported and the port's is loaded once.
``tests/test_torch_deploy_engines.py`` holds the early-exit, progressive,
streaming and bf16 programs, the fresh interpreter and the CLIs. A CUDA
program's kernel is checked on the card by ``chip_smoke.py`` phase 26.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tdanet_best, perturb_flat, \
    port_tdanet_best

from tdanet_tpu_torch import deploy as tdeploy
from tdanet_tpu_torch.kernels import _build
from tdanet_tpu_torch.utils import separate_batched

SR = 8000
CFG = dict(out_channels=32, in_channels=64, num_blocks=1,
           upsampling_depth=4, enc_kernel_size=4, num_sources=2,
           sample_rate=SR)
DEEP = {**CFG, "num_blocks": 3}
LENGTHS = (0.5, 0.43)  # two lattice buckets: 4096, 3584


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wavs(seconds, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(SR * s)) * 0.1).astype(np.float32)
            for s in seconds]


@pytest.fixture(scope="module")
def pair():
    """(JAX model, perturbed flat f32 params, the port's fp32 model)."""
    jmodel, flat = jax_tdanet_best(CFG, seed=41)
    return jmodel, flat, port_tdanet_best(CFG, flat, torch.float32)


@pytest.fixture(scope="module")
def bundles(pair, tmp_path_factory):
    """The JAX package's bundle and the port's of one model's weights:
    LENGTHS, batch 3, for the CPU. Returns (JAX dir, port dir, port
    meta)."""
    from tdanet_tpu import deploy as jdeploy
    from tdanet_tpu.models import flat_torch_to_pytree
    jmodel, flat, model = pair
    root = tmp_path_factory.mktemp("bundles")
    jdeploy.save_bundle(str(root / "jax"), jmodel,
                        flat_torch_to_pytree(flat), lengths=LENGTHS,
                        batch_size=3, platforms=("cpu",))
    meta = tdeploy.save_bundle(str(root / "port"), model, lengths=LENGTHS,
                               batch_size=3, devices=("cpu",))
    return root / "jax", root / "port", meta


@pytest.fixture(scope="module")
def port_dep(bundles):
    """The port's bundle, loaded for the CPU."""
    return tdeploy.load_bundle(str(bundles[1]), device="cpu")


def test_params_and_meta_match_the_jax_bundle(pair, bundles):
    """params.npz: the JAX bundle's names and values; meta.json: the JAX
    keys, ``platforms`` and ``jax_version`` as ``devices`` and
    ``torch_version``; one program file a bucket and device."""
    from tdanet_tpu import deploy as jdeploy
    jdir, pdir, meta = bundles
    with np.load(jdir / "params.npz") as j, np.load(pdir / "params.npz") as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            assert p[k].dtype == np.float32
            np.testing.assert_array_equal(p[k], j[k])
    with open(jdir / "meta.json") as f:
        jmeta = json.load(f)
    assert set(jmeta) - {"platforms", "jax_version"} <= set(meta)
    for k in set(jmeta) - {"platforms", "jax_version"}:
        assert meta[k] == jmeta[k], k
    assert meta["devices"] == ["cpu"] and meta["kernels"] == {}
    assert meta["torch_version"] == str(torch.__version__)
    assert set(os.listdir(pdir / "programs")) == {
        f"T{t}_B3.cpu.pt2" for t in meta["targets"]} == set(
        meta["programs"])
    # the flat round trip: every state-dict entry, bit for bit
    state = pair[2].state_dict()
    back = tdeploy._unflatten(tdeploy._flatten(state))
    assert list(back) == list(state)
    for k, v in state.items():
        assert torch.equal(back[k], v)
    jflat = jdeploy._flatten(jdeploy._unflatten(
        {k: np.asarray(v) for k, v in pair[1].items()}))
    assert sorted(jflat) == sorted(tdeploy._flatten(state))


def test_bundle_matches_the_jax_bundle(bundles, port_dep):
    """The two packages' bundles on the same utterances (two buckets, a
    full and a ragged batch): max abs within 1e-4 of the JAX peak."""
    from tdanet_tpu import deploy as jdeploy
    wavs = _wavs(LENGTHS + (0.5, 0.43, 0.5, 0.49), seed=1)
    want = jdeploy.load_bundle(str(bundles[0])).separate_batched(wavs)
    got = port_dep.separate_batched(wavs)
    for g, w, src in zip(got, want, wavs):
        assert g.shape == w.shape == (2, src.shape[-1])
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


def test_bundle_matches_separate_batched(pair, port_dep):
    """Lattice-exact routing: every utterance runs in its own bucket's
    program, so the bundle gives the port's ``separate_batched``; every
    program holds one #1 node a site."""
    wavs = _wavs(LENGTHS + (0.5, 0.43, 0.44), seed=2)
    dep = port_dep
    got = dep.separate_batched(wavs)
    want = separate_batched(pair[2], wavs, batch_size=3)
    for g, w, src in zip(got, want, wavs):
        assert g.shape == (2, src.shape[-1])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert sorted(dep.programs) == [3584, 4096]
    assert [tdeploy.op_nodes(m) for m in dep.modules.values()] == [25] * 2


def test_coarse_routing_and_its_errors(pair, port_dep):
    """Without the exact program: the default raises with guidance; coarse
    mode routes up a bucket, a renorm-kept approximation; past the
    largest bucket it raises in both modes."""
    wav, long = _wavs((0.45, 0.6), seed=4)
    with pytest.raises(ValueError, match="lattice-exact"):
        port_dep.separate(wav)
    dep = tdeploy.DeployedSeparator(port_dep.meta, port_dep.modules, "cpu",
                                    coarse=True)
    got = dep.separate(wav)
    assert got.shape == (2, wav.shape[-1])
    want = separate_batched(pair[2], [wav], batch_size=3)[0]
    assert np.abs(got - want).max() > 0
    np.testing.assert_allclose(np.abs(got).sum(), np.abs(wav).sum(),
                               rtol=1e-4)
    with pytest.raises(ValueError, match="exceeds every exported bucket"):
        dep.separate(long)


def test_reweight_from_a_jax_written_params_npz(pair, bundles, port_dep,
                                                tmp_path):
    """A params.npz the JAX package writes (its ``_flatten`` of other
    weights) re-weights the port's bundle without export; a file that
    lacks a weight is refused."""
    from tdanet_tpu import deploy as jdeploy
    from tdanet_tpu.models import flat_torch_to_pytree
    from tdanet_tpu_torch.models import TDANetBest, load_jax_params
    _, pdir, _ = bundles
    wav = _wavs((0.5,), seed=5)[0]
    flat2 = jdeploy._flatten(flat_torch_to_pytree(
        perturb_flat(pair[1], seed=7)))
    np.savez(tmp_path / "params2.npz", **flat2)
    dep2 = tdeploy.load_bundle(str(pdir), device="cpu",
                               params_npz=str(tmp_path / "params2.npz"))
    got = dep2.separate(wav)
    model2 = load_jax_params(TDANetBest(**CFG).eval(), flat2)
    want = separate_batched(model2, [wav], batch_size=3)[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not np.allclose(got, port_dep.separate(wav))
    flat2.pop(sorted(flat2)[0])
    np.savez(tmp_path / "short.npz", **flat2)
    with pytest.raises(ValueError, match="do not match"):
        tdeploy.load_bundle(str(pdir), device="cpu",
                            params_npz=str(tmp_path / "short.npz"))


def test_a_jax_bundle_is_refused(bundles):
    """A bundle the JAX package wrote holds .shlo programs: every loader
    says so."""
    jdir = str(bundles[0])
    for load in (tdeploy.load_bundle, tdeploy.load_progressive,
                 tdeploy.load_streaming):
        with pytest.raises(ValueError, match="written by the JAX package"):
            load(jdir, device="cpu")


def test_loaders_refuse_programs_the_bundle_lacks(bundles):
    """A bundle of bucket programs alone has no early-exit depth, no
    progressive pair and no streaming program: each loader says which."""
    pdir = str(bundles[1])
    for load, kw, what in (
            (tdeploy.load_bundle, dict(num_blocks=1), "early-exit depths"),
            (tdeploy.load_progressive, {}, "no progressive programs"),
            (tdeploy.load_streaming, {}, "no streaming program")):
        with pytest.raises(ValueError, match=what):
            load(pdir, device="cpu", **kw)


def test_no_card_and_no_fallback(bundles, monkeypatch, tmp_path):
    """CUDA without a card raises; a CPU bundle is not run on the card;
    a CUDA bundle whose recorded kernel source differs from the installed
    one is refused before any program loads; a CUDA program records the
    library its #1 nodes call."""
    _, pdir, _ = bundles
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdeploy.load_bundle(str(pdir))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=r"not cuda"):
        tdeploy.load_bundle(str(pdir), device="cuda")
    stale = tmp_path / "stale"
    shutil.copytree(pdir, stale)
    with open(stale / "meta.json") as f:
        meta = json.load(f)
    meta["devices"].append("cuda")
    meta["kernels"] = {"dw_conv_glob_ln": {
        "library": "libdw_conv_glob_ln-0123456789abcdef.so",
        "source_hash": "0123456789abcdef"}}
    with open(stale / "meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(RuntimeError, match="hashes"):
        tdeploy.load_bundle(str(stale), device="cuda")
    program = tdeploy._load_program(
        str(pdir / "programs" / "T4096_B3.cpu.pt2"), torch.device("cpu"),
        tdeploy._weights(str(pdir), None))
    assert tdeploy._kernels(program) == {"dw_conv_glob_ln": {
        "library": _build.library_path("dw_conv_glob_ln").name,
        "source_hash": _build.source_hash("dw_conv_glob_ln")}}
