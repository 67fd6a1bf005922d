"""The port's eval slice against the JAX package's: the bucketed eval
stream, the staged (progressive) forward, progressive separation and its
stream, and CSS stitching, on the CPU. The model is a small TDANetBest
(width 32/64, 3 blocks, pyramid depth 3, 8 kHz) with the same perturbed
weights on both sides; float64 unless a test says otherwise. The two eval
CLIs end to end are in ``test_torch_eval_cli.py``."""
import functools

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tdanet_best, port_tdanet_best

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tdanet_tpu_torch import progressive as tprog  # noqa: E402
from tdanet_tpu_torch.utils import css as tcss  # noqa: E402
from tdanet_tpu_torch.utils import separator as tsep  # noqa: E402

CFG = dict(out_channels=32, in_channels=64, num_blocks=3,
           upsampling_depth=3, enc_kernel_size=4, num_sources=2,
           sample_rate=8000)
SR = 8000
TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Np64:
    """numpy with float32 read as float64: the JAX eval paths store their
    estimates in float32; here they keep float64 beside the port."""
    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, float64 JAX params, the port's float64 model)."""
    from tdanet_tpu.models import flat_torch_to_pytree
    jmodel, flat = jax_tdanet_best(CFG, seed=21)
    with jax.enable_x64():
        params = flat_torch_to_pytree(
            {k: np.asarray(v, np.float64) for k, v in flat.items()})
    return jmodel, params, port_tdanet_best(CFG, flat, torch.float64)


@pytest.fixture
def x64(monkeypatch):
    """JAX in float64, its eval modules' float32 host arrays too."""
    from tdanet_tpu import progressive as jprog
    from tdanet_tpu.utils import separator as jsep
    monkeypatch.setattr(jsep, "np", _Np64())
    monkeypatch.setattr(jprog, "np", _Np64())
    with jax.enable_x64():
        yield


def _items(lengths, seed):
    """(mix, sources, key) float32 items, as an eval dataset gives."""
    rng = np.random.default_rng(seed)
    return [((0.1 * rng.standard_normal(L)).astype(np.float32),
             (0.1 * rng.standard_normal((2, L))).astype(np.float32),
             f"utt{i}.wav") for i, L in enumerate(lengths)]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == np.float64
    scale = float(np.abs(want).max())
    assert scale > 1e-6
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


# -- the bucketed eval stream --------------------------------------------

def test_batched_stream_matches_jax_with_a_ragged_chunk(pair, x64):
    """Two buckets at batch_size 2: the 640 bucket holds three utterances
    (a full chunk and a ragged one of 1 row, which JAX pads to 2 and the
    port runs alone). Same yield order, items passed through, estimates
    within 1e-10."""
    from tdanet_tpu.utils.separator import separate_batched_stream as jss
    jmodel, params, tmodel = pair
    lengths = [635, 640, 1277, 620, 1280]
    items = _items(lengths, 1)
    want = list(jss(jmodel, params, lengths, lambda i: items[i],
                    batch_size=2, compute_dtype=jnp.float64))
    got = list(tsep.separate_batched_stream(tmodel, lengths,
                                            lambda i: items[i],
                                            batch_size=2))
    assert [i for i, _, _ in got] == [i for i, _, _ in want] == [0, 1, 3,
                                                                 2, 4]
    for (i, item, est), (_, _, w) in zip(got, want):
        assert item is items[i] and est.shape == (2, lengths[i])
        _close(est, w)


def test_separate_batched_is_the_stream_in_input_order(pair):
    _, _, tmodel = pair
    wavs = [it[0] for it in _items([700, 650, 1300], 2)]
    outs = tsep.separate_batched(tmodel, wavs, batch_size=2)
    stream = {i: est for i, _, est in tsep.separate_batched_stream(
        tmodel, [len(w) for w in wavs], lambda i: (wavs[i],), 2)}
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, stream[i])


def test_reader_error_reaches_the_consumer():
    def get(i):
        if i == 2:
            raise OSError("unreadable wav")
        return (np.zeros(4, np.float32),)
    plan = tsep.plan_lattice_buckets([4, 4, 4], 4, 8)
    q, close = tsep.start_prefetch_reader(plan, get, 1)
    tsep.take_item(q), tsep.take_item(q)
    with pytest.raises(OSError, match="unreadable"):
        tsep.take_item(q)
    close()


@pytest.mark.parametrize("stream", ["batched", "progressive"])
def test_leaving_a_stream_early_stops_its_reader(pair, stream):
    """A consumer that leaves after the first utterance: closing the
    stream stops its reader, which was blocked on a full queue, and joins
    it; the reader read no more than its queue holds past what was
    taken."""
    import threading
    _, _, tmodel = pair
    n_threads = threading.active_count()
    lengths = [600] * 12
    read = []

    def get(i):
        read.append(i)
        return (np.zeros(lengths[i], np.float32),)
    if stream == "batched":
        gen = tsep.separate_batched_stream(tmodel, lengths, get,
                                           batch_size=1)
    else:
        gen = tprog.separate_progressive_stream(
            tmodel, lengths, get, depth1=2, batch_size=1, group_size=1)
    next(gen)
    gen.close()
    assert threading.active_count() == n_threads
    assert len(read) <= 1 + 1 + tsep.PREFETCH_BATCHES + 1


def test_eval_sites_are_the_sites_a_forward_runs():
    """The chip probe's site prediction (which it holds against plain
    before its runs) equals the depthwise sites that per-utterance
    forwards of those lengths and row counts launch, at pyramid depth 5,
    on and off the stride lattice."""
    from tdanet_tpu_torch.models import TDANetBest
    from tdanet_tpu_torch.probes import eval_path
    model = TDANetBest(out_channels=8, in_channels=16, num_blocks=2,
                       upsampling_depth=5, enc_kernel_size=4, num_sources=2,
                       sample_rate=SR)
    model.reset_parameters(torch.Generator().manual_seed(0))
    rows = {1000: (1, 3), 2 * model.lcm: (2,)}
    with eval_path.recorded_sites() as seen, torch.inference_mode():
        for length, counts in rows.items():
            for B in counts:
                model(torch.zeros(B, length), per_utterance=True)
    assert seen == eval_path.eval_sites(model, rows)
    assert {k[0] for k in seen} == {1, 2, 3}


# -- the staged forward ----------------------------------------------------

def test_stages_match_jax_and_continue_exactly(pair):
    """forward_stage1/forward_stage2 against apply_stage1/apply_stage2 (B 2,
    off the lattice, the batch-axis attention of the default forward): the
    estimates, the state and delta within 1e-10; stage 1 equals the depth-2
    forward and stage 1 + stage 2 the full-depth forward, bit for bit."""
    jmodel, params, tmodel = pair
    x = np.random.default_rng(3).standard_normal((2, 1000))
    T = x.shape[-1]
    with jax.enable_x64():
        jest, jst = jmodel.apply_stage1(params, jnp.asarray(x), depth=2,
                                        compute_dtype=jnp.float64)
        jest2 = jmodel.apply_stage2(params, jst, n_more=1,
                                    rest=jmodel.pad_rest(T))
        jest, jest2 = np.asarray(jest), np.asarray(jest2)
        jst = {k: np.asarray(v) for k, v in jst.items()}
    assert tmodel.pad_rest(T) == jmodel.pad_rest(T)
    xt = torch.from_numpy(x)
    est, st = tmodel.forward_stage1(xt, 2)
    est2 = tmodel.forward_stage2(st, 1, tmodel.pad_rest(T))
    _close(est.numpy(), jest)
    _close(est2.numpy(), jest2)
    for k in ("mixture", "carry", "enc", "delta"):
        _close(st[k].numpy(), jst[k])
    assert st["depth"] == 2 and (st["delta"] > 0).all()
    with torch.inference_mode():
        assert torch.equal(est, tmodel(xt, num_blocks=2))
        assert torch.equal(est2, tmodel(xt))
        one = tmodel.forward_stage1(xt[:1], 2, per_utterance=True)[0]
        assert torch.equal(one, tmodel(xt[:1], num_blocks=2))


def test_recurrent_state_depth_bounds(pair):
    _, _, tmodel = pair
    feats = torch.zeros(1, CFG["out_channels"], 64, dtype=torch.float64)
    for bad in (0, 1, CFG["num_blocks"] + 1):
        with pytest.raises(ValueError, match="n_iter"):
            tmodel.sm.forward_with_state(feats, n_iter=bad)
    with pytest.raises(ValueError, match="n_iter"):
        tmodel.sm.continue_forward(feats, feats, 2, depth=2)
    with pytest.raises(ValueError, match="n_iter"):
        tmodel.sm.continue_forward(feats, feats, 0, depth=2)


# -- progressive separation ------------------------------------------------

def _jax_separate_progressive(jmodel, params, mixes, **kw):
    from tdanet_tpu.progressive import separate_progressive
    return separate_progressive(jmodel, params, mixes,
                                compute_dtype=jnp.float64, **kw)


def test_partial_escalation_matches_jax(pair, x64):
    """At a threshold halfway between the middle deltas: the same
    escalated set (a strict, non-empty subset), deltas and estimates
    within 1e-10, escalated rows equal to the full-depth forward and the
    others to the depth-2 one."""
    jmodel, params, tmodel = pair
    mixes = (0.1 * np.random.default_rng(4).standard_normal(
        (5, 1000))).astype(np.float32)
    _, info0 = _jax_separate_progressive(jmodel, params, mixes, depth1=2,
                                         threshold=np.inf, batch_size=2)
    # not a delta itself, where rounding would decide the comparison
    thr = float(np.mean(np.sort(info0["delta"])[2:4]))
    want, winfo = _jax_separate_progressive(jmodel, params, mixes, depth1=2,
                                            threshold=thr, batch_size=2)
    got, info = tprog.separate_progressive(tmodel, mixes, depth1=2,
                                           threshold=thr, batch_size=2)
    assert 0 < info["n_escalated"] < len(mixes)
    np.testing.assert_array_equal(info["escalated"], winfo["escalated"])
    assert (info["depth1"], info["depth_full"]) == (2, 3)
    _close(info["delta"], winfo["delta"])
    _close(got, want)
    with torch.inference_mode():
        for i, esc in enumerate(info["escalated"]):
            x = torch.from_numpy(mixes[i:i + 1]).double()
            ref = tmodel(x, num_blocks=3 if esc else 2)[0].numpy()
            np.testing.assert_array_equal(got[i], ref)


def test_progressive_stream_matches_jax_census(pair, x64):
    """Two buckets, group_size 3 (the escalations of a group pool into
    shared stage-2 batches): the same yield order, estimates and census."""
    from tdanet_tpu.progressive import separate_progressive_stream as jps
    jmodel, params, tmodel = pair
    lengths = [640, 600, 1280, 633, 610, 1250]
    items = _items(lengths, 5)
    deltas = []
    for target, idx in tsep.plan_lattice_buckets(lengths, tmodel.lcm, 8):
        mixes = np.zeros((len(idx), target), np.float32)
        for row, i in enumerate(idx):
            mixes[row, :lengths[i]] = items[i][0]
        deltas += list(tprog.separate_progressive(
            tmodel, mixes, depth1=2, threshold=np.inf)[1]["delta"])
    thr = float(np.mean(np.sort(deltas)[2:4]))
    kw = dict(depth1=2, threshold=thr, batch_size=2, group_size=3)
    wstats, gstats = {}, {}
    want = list(jps(jmodel, params, lengths, lambda i: items[i],
                    compute_dtype=jnp.float64, stats=wstats, **kw))
    got = list(tprog.separate_progressive_stream(
        tmodel, lengths, lambda i: items[i], stats=gstats, **kw))
    assert [i for i, _, _ in got] == [i for i, _, _ in want]
    for (_, _, est), (_, _, w) in zip(got, want):
        _close(est, w)
    assert 0 < gstats["n_escalated"] < len(lengths)
    assert {k: gstats[k] for k in ("n", "n_escalated", "depth1",
                                   "depth_full")} == \
        {k: wstats[k] for k in ("n", "n_escalated", "depth1", "depth_full")}
    for k in ("delta_sum", "delta_mean"):
        assert abs(gstats[k] - wstats[k]) <= TOL * abs(wstats[k])


def test_progressive_guards_and_empty_stream(pair):
    _, _, tmodel = pair
    mixes = np.zeros((2, 640), np.float32)
    with pytest.raises(ValueError, match="trained depth"):
        tprog.separate_progressive(tmodel, mixes, depth1=2, depth_full=4)
    with pytest.raises(ValueError, match="must exceed"):
        tprog.separate_progressive(tmodel, mixes, depth1=3)

    class NotStaged(torch.nn.Module):
        num_blocks = 3
    with pytest.raises(TypeError, match="TDANetBest"):
        tprog.separate_progressive(NotStaged(), mixes, depth1=2)
    # threshold 0 escalates exact-zero deltas (all-silent input)
    _, info = tprog.separate_progressive(tmodel, mixes, depth1=2,
                                         threshold=0.0)
    assert info["n_escalated"] == 2
    stats = {}
    assert list(tprog.separate_progressive_stream(
        tmodel, [], lambda i: None, depth1=2, stats=stats)) == []
    assert stats == dict(n=0, n_escalated=0, delta_sum=0.0, delta_mean=0.0,
                         depth1=2, depth_full=3)


# -- CSS stitching ---------------------------------------------------------

def test_stitch_chain_matches_jax_with_a_tie_and_frozen_tails():
    """Random segments where each head copies the previous segment's
    reversed tails (so aligning against segment 0, the reference's frozen
    tails, and against the predecessor disagree), and an exact tie, which
    swaps: the port's chain equals the JAX package's bit for bit."""
    from tdanet_tpu.utils.css import stitch_chain as jchain
    rng = np.random.default_rng(0)
    L, ov = 64, 16
    swaps = []
    for trial in range(12):
        K = int(rng.integers(3, 7))
        est = rng.standard_normal((K, 2, L))
        if trial % 2:
            for k in range(1, K):
                est[k, :, :ov] = est[k - 1, :, -ov:][::-1]
        np.testing.assert_array_equal(tcss.stitch_chain(est, ov),
                                      jchain(est, ov))
        swaps += tcss.chain_swaps(est, ov)
    assert any(swaps) and not all(swaps)
    tie = np.ones((2, 2, L))
    assert tcss.chain_swaps(tie, ov) == [True]
    np.testing.assert_array_equal(tcss.stitch_chain(tie, ov),
                                  jchain(tie, ov))
    with pytest.raises(ValueError, match="overlap"):
        tcss.stitch_chain(np.zeros((2, 2, L)), 0)


@pytest.mark.parametrize("progressive", [False, True])
def test_stitch_segments_matches_jax(pair, x64, monkeypatch, progressive):
    """Five 0.125 s segments (off the lattice) stitched with an overlap of
    200 samples, by the full-depth forward or progressively (depth 2, all
    escalated): within 1e-10 of the JAX stitcher in float64; the port's
    result does not depend on its batch size."""
    from tdanet_tpu import progressive as jprog
    from tdanet_tpu.utils import css as jcss
    jmodel, params, tmodel = pair
    monkeypatch.setattr(jcss, "_segment_fwd", lambda m: jax.jit(jax.vmap(
        lambda p, s: m.apply(p, s[None], compute_dtype=jnp.float64)[0],
        in_axes=(None, 0))))
    monkeypatch.setattr(jprog, "separate_progressive", functools.partial(
        jprog.separate_progressive, compute_dtype=jnp.float64))
    segs = list((0.1 * np.random.default_rng(6).standard_normal(
        (5, 1000))).astype(np.float32))
    kw = dict(progressive_depth=2, progressive_threshold=0.0) \
        if progressive else {}
    want = jcss.stitch_segments(jmodel, params, segs, 200, **kw)
    got = tcss.stitch_segments(tmodel, segs, 200, **kw)
    assert got.shape == (2, 1000 + 4 * 800)
    _close(got, want)
    np.testing.assert_array_equal(
        tcss.stitch_segments(tmodel, segs, 200, batch_size=2, **kw), got)
