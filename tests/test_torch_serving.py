"""The port's serving engines (``tdanet_tpu_torch/serving.py``) against the
JAX package's (``tdanet_tpu/serving.py``) on the same weights, and the
behaviours of ``tests/test_serving.py`` that need no mesh, on the CPU.

The model is a small TDANetBest (width 32/64, 1 block, pyramid depth 4,
8 kHz), as in ``tests/test_serving.py``. The port runs in float64; each JAX
engine runs in float64 too (``jax.enable_x64``, its module's float32 host
arrays read as float64), so its outputs are checked to be float64 and the
tolerance is 1e-9 of the peak; int16 emission within one step. On the CPU
the engines run the eager forward; the three ``gpu`` tests hold the CUDA
graphs against it on the card:

    python -m pytest --noconftest tests/test_torch_serving.py -m gpu
"""
import threading
import time

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tdanet_best, port_tdanet_best

from tdanet_tpu_torch import serving as tserving

CFG = dict(out_channels=32, in_channels=64, num_blocks=1,
           upsampling_depth=4, enc_kernel_size=4, num_sources=2,
           sample_rate=8000)
SR = 8000
TOL = 1e-9
WAIT = 120  # seconds any future may take


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Np64:
    """numpy with float32 read as float64: the JAX engines keep their host
    arrays in float32; here they keep float64 beside the port."""
    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


def _x64_patches(mp):
    from tdanet_tpu import serving as jserving
    from tdanet_tpu.utils import css as jcss
    from tdanet_tpu.utils import separator as jsep
    for module in (jserving, jsep, jcss):
        mp.setattr(module, "np", _Np64())


@pytest.fixture(scope="module")
def pair():
    """(JAX model, float64 JAX params, the port's float64 model)."""
    jax = pytest.importorskip("jax")
    from tdanet_tpu.models import flat_torch_to_pytree
    jmodel, flat = jax_tdanet_best(CFG, seed=31)
    with jax.enable_x64():
        params = flat_torch_to_pytree(
            {k: np.asarray(v, np.float64) for k, v in flat.items()})
    return jmodel, params, port_tdanet_best(CFG, flat, torch.float64)


@pytest.fixture
def x64(monkeypatch):
    """JAX in float64, its serving, separator and css modules' host arrays
    too."""
    import jax
    _x64_patches(monkeypatch)
    with jax.enable_x64():
        yield


def _noise(T, rng, scale=0.1):
    return (scale * rng.standard_normal(T)).astype(np.float32)


def _close(got, want, tol=TOL):
    """Same shape; the port's float64 within ``tol`` of the JAX float64
    peak."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype == np.float64, (got.dtype, want.dtype)
    scale = float(np.abs(want).max())
    assert scale > 1e-6
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


# request sets: A mixes two lattice buckets (8192 and 8448 samples), B is
# the adaptive test's standing queue (one bucket)
SET_A = (SR, SR, SR + 300, SR, SR + 300, SR, SR + 300, SR + 300)
SET_B = (SR,) * 40


@pytest.fixture(scope="module")
def requests():
    rng = np.random.default_rng(4)
    return {"A": [_noise(T, rng) for T in SET_A],
            "B": [_noise(T, rng) for T in SET_B]}


@pytest.fixture(scope="module")
def jax_batched(pair, requests):
    """The JAX package's separate_batched (float64) over both request sets
    in one call: batch 4 fills every chunk, so two programs compile. The
    requests go in as float64 (the same values), so that the renormalising
    sum of each mixture is taken in float64, as the port takes it."""
    import jax
    import jax.numpy as jnp
    from tdanet_tpu.utils.separator import separate_batched
    jmodel, params, _ = pair
    wavs = [w.astype(np.float64) for w in requests["A"] + requests["B"]]
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64():
        _x64_patches(mp)
        out = separate_batched(jmodel, params, wavs, batch_size=4,
                               compute_dtype=jnp.float64)
    n = len(requests["A"])
    return {"A": out[:n], "B": out[n:]}


def _drive_stream(engine, wav, sizes):
    outs, pos = [], 0
    for size in sizes:
        chunk = wav[pos:pos + size]
        pos += len(chunk)
        outs.append(engine.push(chunk))
        if pos >= len(wav):
            break
    outs.append(engine.flush())
    return np.concatenate(outs, axis=1)


RAGGED = (1000, 3777, 5000, 200, 9000, 10 ** 9)


# -- against the JAX engines --------------------------------------------


def test_streaming_matches_jax_engine(pair, x64):
    """The same ragged chunks through both StreamingSeparators: the same
    samples out, to 1e-9 of the peak, the input's length."""
    import jax.numpy as jnp
    from tdanet_tpu.serving import StreamingSeparator
    jmodel, params, tmodel = pair
    wav = _noise(int(SR * 3.3), np.random.default_rng(0))
    kw = dict(segment=1.0, overlap=0.25, sample_rate=SR)
    want = _drive_stream(StreamingSeparator(
        jmodel, params, compute_dtype=jnp.float64, **kw), wav, RAGGED)
    got = _drive_stream(tserving.StreamingSeparator(tmodel, **kw), wav,
                        RAGGED)
    assert got.shape == (2, len(wav))
    _close(got, want)


def _drive_multi(engine, wavs, sizes):
    """Interleaved uneven pushes, stepping as they go, then a flush each."""
    got = {i: [] for i in range(len(wavs))}
    for i in range(len(wavs)):
        engine.open(i)
    pos = [0] * len(wavs)
    for size in sizes:
        for i, w in enumerate(wavs):
            if pos[i] < len(w):
                chunk = w[pos[i]:pos[i] + size + 531 * i]
                pos[i] += len(chunk)
                engine.push(i, chunk)
        while True:
            out = engine.step()
            if not out:
                break
            for i, o in out.items():
                got[i].append(o)
    return [np.concatenate(got[i] + [engine.flush(i)], axis=1)
            for i in range(len(wavs))]


@pytest.mark.parametrize("emit", ["float32", "int16"])
def test_multistream_matches_jax_engine(pair, x64, emit):
    """Three streams through both MultiStreamSeparators (max_streams 4):
    float estimates to 1e-9 of the peak; int16 emission within one step
    (a rounding tie may land either side of 1e-9)."""
    import jax.numpy as jnp
    from tdanet_tpu.serving import MultiStreamSeparator
    jmodel, params, tmodel = pair
    rng = np.random.default_rng(1)
    wavs = [_noise(int(SR * 2.6), rng, 0.05) for _ in range(3)]
    kw = dict(max_streams=4, segment=1.0, overlap=0.25, sample_rate=SR,
              emit_dtype=emit)
    want = _drive_multi(MultiStreamSeparator(
        jmodel, params, compute_dtype=jnp.float64, **kw), wavs, RAGGED)
    got = _drive_multi(tserving.MultiStreamSeparator(tmodel, **kw), wavs,
                       RAGGED)
    for g, w, wav in zip(got, want, wavs):
        assert g.shape == w.shape == (2, len(wav))
        if emit == "int16":
            assert g.dtype == w.dtype == np.int16
            assert np.abs(g.astype(np.int32) - w).max() <= 1
            assert np.abs(w).max() > 100
        else:
            _close(g, w)


def _close_in(got, want, compute_dtype):
    """float64 to 1e-9 of the JAX float64 peak; with compute_dtype float32,
    float32 estimates to 1e-4 of it (fp32 rounding through the model)."""
    if compute_dtype is None:
        return _close(got, want)
    assert got.dtype == np.float32 and got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("compute_dtype", [None, torch.float32])
def test_async_server_matches_jax_separate_batched(pair, requests,
                                                   jax_batched,
                                                   compute_dtype):
    """Mixed lengths submitted at once resolve to the JAX separate_batched
    estimates, coalesced into few dispatches."""
    _, _, tmodel = pair
    server = tserving.AsyncBatchServer(tmodel, max_batch=4, max_wait_ms=50,
                                       compute_dtype=compute_dtype)
    try:
        futs = [server.submit(w) for w in requests["A"]]
        got = [f.result(timeout=WAIT) for f in futs]
        assert server.stats["rows"] == len(futs)
        assert server.stats["dispatches"] < len(futs)
    finally:
        server.close()
    for g, w in zip(got, jax_batched["A"]):
        _close_in(g, w, compute_dtype)


@pytest.mark.parametrize("compute_dtype", [None, torch.float32])
def test_batch_server_matches_jax_separate_batched(pair, requests,
                                                   jax_batched,
                                                   compute_dtype):
    """BatchSeparationServer passes batch_size and compute_dtype to
    separate_batched."""
    _, _, tmodel = pair
    got = tserving.BatchSeparationServer(
        tmodel, batch_size=3, compute_dtype=compute_dtype).separate(
        requests["A"])
    for g, w in zip(got, jax_batched["A"]):
        _close_in(g, w, compute_dtype)


def test_async_batch_server_adaptive_grows_under_overload(pair, requests,
                                                          jax_batched):
    """Under a standing queue the batch size climbs the ladder, results
    equal the JAX separate_batched path, and the rung falls back to 0 when
    traffic thins."""
    _, _, tmodel = pair
    server = tserving.AsyncBatchServer(tmodel, max_batch=8, max_wait_ms=2,
                                       adaptive=True, min_batch=2)
    assert server._ladder == [2, 4, 8]
    try:
        futs = [server.submit(w) for w in requests["B"]]  # the queue stands
        got = [f.result(timeout=WAIT) for f in futs]
        for g, w in zip(got, jax_batched["B"]):
            _close(g, w)
        assert server.stats["rung_highwater"] >= 1, server.stats
        assert server.stats["rows"] == 40
        for _ in range(12):  # lone requests shrink the rung back
            server.separate(requests["B"][0], timeout=WAIT)
            time.sleep(0.01)
        assert server._rung == 0, (server._rung, server.stats)
    finally:
        server.close()


def test_async_batch_server_length_buckets(pair, x64):
    """Requests pad to the configured coarse buckets (one program per
    bucket); one longer than the largest bucket pads to the lattice. Each
    answer equals the JAX model's forward of the request padded to its
    bucket, trimmed and renormalised (1e-9 of the peak)."""
    import jax.numpy as jnp
    from tdanet_tpu.utils.separator import trim_renorm
    jmodel, params, tmodel = pair
    rng = np.random.default_rng(1)
    lengths = [SR // 2, SR - 321, SR + 123, 2 * SR - 7, SR // 3,
               3 * SR + 17]
    wavs = [_noise(T, rng) for T in lengths]
    server = tserving.AsyncBatchServer(tmodel, max_batch=4, max_wait_ms=50,
                                       length_buckets=[SR, 2 * SR])
    try:
        server.prewarm()
        assert len(server._fwd_cache) == 2
        futs = [server.submit(w) for w in wavs]
        got = [f.result(timeout=WAIT) for f in futs]
        targets = {t for t, _ in server._fwd_cache}
        assert set(server.length_buckets) <= targets and len(targets) == 3
    finally:
        server.close()
    for g, wav in zip(got, wavs):
        x = np.zeros((1, server._target(len(wav))), np.float64)
        x[0, :len(wav)] = wav
        est = np.asarray(jmodel.apply(params, jnp.asarray(x),
                                      compute_dtype=jnp.float64)[0])
        _close(g, trim_renorm(wav.astype(np.float64), est))


def test_streaming_matches_offline_stitcher(pair, x64):
    """Chunks of any size through the port's StreamingSeparator give the
    JAX offline stitcher's output on the reference's slicing (1e-9)."""
    from tdanet_tpu.utils.css import stitch_segments
    jmodel, params, tmodel = pair
    wav = _noise(int(SR * 3.3), np.random.default_rng(0))
    seg_len = SR
    overlap_len = seg_len // 4
    segs, start, pad_len = [], 0, 0
    while start < len(wav):
        s = wav[start:start + seg_len]
        if start + seg_len > len(wav):
            pad_len = start + seg_len - len(wav)
            s = np.concatenate([s, np.zeros(pad_len, np.float32)])
            start += pad_len
        segs.append(s)
        start += seg_len - overlap_len
    want = np.asarray(stitch_segments(jmodel, params, segs, overlap_len))
    want = want[:, :-pad_len] if pad_len else want
    got = _drive_stream(tserving.StreamingSeparator(
        tmodel, segment=1.0, overlap=0.25, sample_rate=SR), wav, RAGGED)
    _close(got, want)


# -- the port against itself (tests/test_serving.py's behaviours) ---------


def _model(pair):
    return pair[2]


def test_multistream_matches_single_stream(pair):
    """Streams through one batched forward give what each gives through
    its own StreamingSeparator (rows separated as if alone)."""
    rng = np.random.default_rng(1)
    wavs = [_noise(int(SR * 2.6), rng) for _ in range(3)]
    multi = tserving.MultiStreamSeparator(_model(pair), max_streams=4,
                                          segment=1.0, overlap=0.25,
                                          sample_rate=SR)
    got = _drive_multi(multi, wavs, RAGGED)
    single = tserving.StreamingSeparator(_model(pair), segment=1.0,
                                         overlap=0.25, sample_rate=SR)
    for have, w in zip(got, wavs):
        want = np.concatenate([single.push(w), single.flush()], axis=1)
        assert have.shape == want.shape
        np.testing.assert_allclose(have, want, rtol=1e-10, atol=1e-12)


def test_multistream_int16_emission(pair):
    """int16 emission equals the float path within one quantisation step,
    with the same stitching."""
    w = _noise(int(SR * 1.8), np.random.default_rng(2), 0.05)
    outs = {}
    for dt in ("float32", "int16"):
        m = tserving.MultiStreamSeparator(_model(pair), max_streams=2,
                                          segment=1.0, overlap=0.25,
                                          sample_rate=SR, emit_dtype=dt)
        m.open(0)
        m.push(0, w)
        parts = []
        while True:
            o = m.step()
            if not o:
                break
            parts.append(o[0])
        parts.append(m.flush(0))
        outs[dt] = np.concatenate(parts, axis=1)
    assert outs["int16"].dtype == np.int16
    got = outs["int16"].astype(np.float64) / 32767.0
    np.testing.assert_allclose(got, np.clip(outs["float32"], -1, 1),
                               atol=1.0 / 32767.0)
    with pytest.raises(ValueError, match="emit_dtype"):
        tserving.MultiStreamSeparator(_model(pair), emit_dtype="int8")


def test_pcm16_rounds_ties_to_even_as_jax():
    """Values whose float32 product with 32767 is exactly n + 0.5 (n even
    and odd), the clamp's edges and zero: the port's pcm16 equals
    jnp.round's emission, and an even n stays n (half to even)."""
    import jax.numpy as jnp
    vals, ties = [-2.0, -1.0, 0.0, 1.0, 2.0], 0
    for n in range(1, 4000, 7):
        e = np.float32((n + 0.5) / 32767)
        if np.float32(e * np.float32(32767.0)) == n + 0.5:
            vals += [float(e), -float(e)]
            ties += n % 2 == 0
    assert ties >= 10
    x = np.asarray(vals, np.float32)
    want = np.asarray(jnp.round(jnp.clip(jnp.asarray(x), -1.0, 1.0)
                                * 32767.0).astype(jnp.int16))
    got = tserving.pcm16(torch.from_numpy(x.astype(np.float64))).numpy()
    np.testing.assert_array_equal(got, want)
    even = [(v, g) for v, g in zip(x, got)
            if v > 0 and np.float32(v * np.float32(32767.0)) % 2 == 0.5]
    assert even and all(g == np.floor(v * 32767.0) for v, g in even)


def test_multistream_overflow_and_capacity(pair):
    multi = tserving.MultiStreamSeparator(_model(pair), max_streams=2,
                                          segment=1.0, overlap=0.25,
                                          sample_rate=SR)
    multi.open("a")
    multi.open("b")
    with pytest.raises(ValueError, match="max_streams"):
        multi.open("c")
    # re-opening a live stream raises, and not the capacity error
    with pytest.raises(ValueError, match="already open"):
        multi.open("a")
    multi.push("a", np.zeros(SR * 3, np.float32))
    total = 0
    while True:
        out = multi.step()
        if not out:
            break
        total += out["a"].shape[1]
    assert total > 0
    multi.flush("a")
    multi.flush("b")
    assert multi._streams == {}


def test_streaming_incremental_latency(pair):
    stream = tserving.StreamingSeparator(_model(pair), segment=1.0,
                                         overlap=0.25, sample_rate=SR)
    out = stream.push(np.zeros(SR // 2, np.float32))
    assert out.shape == (2, 0)  # less than a segment: nothing yet
    out = stream.push(np.zeros(SR // 2, np.float32))
    assert out.shape == (2, SR)  # the first segment, whole


def test_multistream_flush_without_step_drains_backlog(pair):
    """flush() of a stream holding more than one full segment separates
    the backlog; it emits exactly what step() then flush() emit."""
    multi = tserving.MultiStreamSeparator(_model(pair), max_streams=2,
                                          segment=1.0, overlap=0.25,
                                          sample_rate=SR)
    rng = np.random.default_rng(7)
    T = int(SR * 2.4)
    multi.open("a")
    multi.push("a", _noise(T, rng))
    assert multi.flush("a").shape == (2, T)
    multi.open("b")  # exactly one segment
    multi.push("b", _noise(multi.seg_len, rng))
    assert multi.flush("b").shape == (2, multi.seg_len)
    wav = _noise(T, rng)
    multi.open("inc")
    multi.push("inc", wav)
    parts = []
    while True:
        got = multi.step()
        if not got:
            break
        parts.append(got["inc"])
    parts.append(multi.flush("inc"))
    multi.open("cold")
    multi.push("cold", wav)
    np.testing.assert_array_equal(multi.flush("cold"),
                                  np.concatenate(parts, axis=1))


@pytest.mark.parametrize("engine", ["streaming", "multistream"])
def test_export_restore_mid_stream(pair, engine):
    """A stream exported mid-way (a partial segment buffered, tails set)
    and restored into a fresh engine continues with no sample dropped or
    repeated: the two halves equal the uninterrupted run exactly."""
    rng = np.random.default_rng(9)
    wav = _noise(int(SR * 3.1), rng)
    cut = int(SR * 1.7)
    kw = dict(segment=1.0, overlap=0.25, sample_rate=SR)
    if engine == "streaming":
        def make():
            return tserving.StreamingSeparator(_model(pair), **kw)

        def run(e, chunk, last):
            out = [e.push(chunk)]
            return out + [e.flush()] if last else out
    else:
        def make():
            return tserving.MultiStreamSeparator(_model(pair), max_streams=2,
                                                 **kw)

        def run(e, chunk, last):
            if "s" not in e._streams:
                e.open("s")
            e.push("s", chunk)
            out = [o["s"] for o in iter(e.step, {})]
            return out + [e.flush("s")] if last else out
    whole = np.concatenate(run(make(), wav, True), axis=1)
    first = make()
    head = run(first, wav[:cut], False)
    state = first.export_state()
    assert (state if engine == "streaming" else state["s"])["consumed"] > 0
    second = make()
    second.restore_state(state)
    tail = run(second, wav[cut:], True)
    got = np.concatenate(head + tail, axis=1)
    assert got.shape == (2, len(wav))
    np.testing.assert_array_equal(got, whole)


@pytest.mark.parametrize("engine", ["streaming", "multistream"])
def test_forward_fn_takes_the_forwards_place(pair, engine):
    """A forward_fn (here the model's forward at half scale) replaces the
    model's forward: the stitched output is exactly half the default
    engine's (the alignment's cosines do not see the scale)."""
    model = _model(pair)
    wav = _noise(int(SR * 2.7), np.random.default_rng(12))
    kw = dict(segment=1.0, overlap=0.25, sample_rate=SR)

    def half(x):
        return 0.5 * model(x, per_utterance=True)

    outs = []
    for fn in (None, half):
        if engine == "streaming":
            e = tserving.StreamingSeparator(model, forward_fn=fn, **kw)
            outs.append(_drive_stream(e, wav, RAGGED))
        else:
            e = tserving.MultiStreamSeparator(model, max_streams=2,
                                              forward_fn=fn, **kw)
            outs.append(_drive_multi(e, [wav], RAGGED)[0])
    assert outs[0].shape == (2, len(wav))
    np.testing.assert_array_equal(outs[1], 0.5 * outs[0])


def test_async_batch_server_failed_rung_build_is_recorded(pair, requests,
                                                          jax_batched,
                                                          monkeypatch):
    """A bigger rung whose background build fails is recorded (stats and
    build_errors), built once, never grown into: the standing queue is
    served at rung 0, every answer equal to the JAX separate_batched."""
    server = tserving.AsyncBatchServer(_model(pair), max_batch=8,
                                       max_wait_ms=2, adaptive=True,
                                       min_batch=2)
    build, tried = server._build_fwd, []

    def failing(target, B):
        if B > 2:
            tried.append((target, B))
            raise RuntimeError("capture failed")
        return build(target, B)

    monkeypatch.setattr(server, "_build_fwd", failing)
    try:
        futs = [server.submit(w) for w in requests["B"]]
        got = [f.result(timeout=WAIT) for f in futs]
        deadline = time.monotonic() + WAIT
        while server._compile_sched and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        server.close()
    for g, w in zip(got, jax_batched["B"]):
        _close(g, w)
    assert server.stats["rung_highwater"] >= 1
    assert server.stats["max_B"] == 2, server.stats
    assert server.stats["build_errors"] == len(server.build_errors) >= 1
    assert sorted(server.build_errors) == sorted(set(tried)) == sorted(tried)
    assert all(str(e) == "capture failed"
               for e in server.build_errors.values())


def test_async_batch_server_error_propagates(pair, monkeypatch):
    """Malformed requests raise at submit(); a forward that fails resolves
    its group's futures with the error; the server keeps serving."""
    tmodel = _model(pair)
    server = tserving.AsyncBatchServer(tmodel, max_batch=2, max_wait_ms=1)
    rng = np.random.default_rng(1)
    try:
        with pytest.raises(ValueError, match="mono"):
            server.submit(np.zeros((0,), np.float32))
        with pytest.raises(ValueError, match="mono"):
            server.submit(np.zeros((2, SR), np.float32))
        forward = tmodel.forward

        def broken(x, *a, **kw):
            if x.shape[-1] == 2 * tmodel.lcm:
                raise RuntimeError("forward failed")
            return forward(x, *a, **kw)

        monkeypatch.setattr(tmodel, "forward", broken)
        with pytest.raises(RuntimeError, match="forward failed"):
            server.separate(_noise(2 * tmodel.lcm - 5, rng), timeout=WAIT)
        ok = server.separate(_noise(SR, rng), timeout=WAIT)
        assert ok.shape == (2, SR)
    finally:
        server.close()


def test_async_batch_server_close_resolves_queued_and_rejects_new(pair):
    server = tserving.AsyncBatchServer(_model(pair), max_batch=2,
                                       max_wait_ms=1)
    rng = np.random.default_rng(8)
    server.separate(_noise(SR, rng), timeout=WAIT)
    futs = [server.submit(_noise(SR, rng)) for _ in range(3)]
    server.close()
    for f in futs:
        try:
            assert f.result(timeout=WAIT).shape[0] == 2  # served before...
        except RuntimeError:
            pass  # ... or refused by the close: never left hanging
    with pytest.raises(RuntimeError):
        server.submit(np.zeros(SR, np.float32))


def test_adaptive_right_size_dispatch_and_sticky_shrink(pair):
    """A group smaller than the current rung goes through the smallest
    ready rung that fits it; a coalesce that would not have fit the lower
    rung does not count toward shrinking."""
    server = tserving.AsyncBatchServer(_model(pair), max_batch=8,
                                       max_wait_ms=2, adaptive=True,
                                       min_batch=2)
    assert server._ladder == [2, 4, 8]
    try:
        target = 8192
        server._rung = 2  # as after a sustained overload
        B, fwd, err = server._pick_fwd(target, n=2)
        assert err is None and fwd is not None and B == 2
        B, _, _ = server._pick_fwd(target, n=8)
        assert B in (2, 8), B
        server._rung, server._idle = 2, 0
        for _ in range(8):
            server._adapt(6)
        assert server._rung == 2
        for _ in range(4):
            server._adapt(3)
        assert server._rung == 1
        for _ in range(4):
            server._adapt(1)
        assert server._rung == 0
    finally:
        server.close()


def test_async_batch_server_deadline_sheds_stale(pair, monkeypatch):
    """Requests older than deadline_ms when their batch is assembled
    resolve with DeadlineExceeded; fresh requests still succeed. The first
    forward is held back 400 ms, as a first capture (or, in JAX, a
    compile) holds it, so the request behind it goes stale."""
    tmodel = _model(pair)
    forward, started = tmodel.forward, threading.Event()

    def slow_first(*a, **kw):
        if not started.is_set():
            started.set()
            time.sleep(0.4)
        return forward(*a, **kw)

    monkeypatch.setattr(tmodel, "forward", slow_first)
    wav = _noise(SR, np.random.default_rng(2))
    server = tserving.AsyncBatchServer(tmodel, max_batch=2, max_wait_ms=1,
                                       deadline_ms=200.0)
    try:
        f0 = server.submit(wav)
        assert started.wait(timeout=WAIT)  # f0's forward is under way
        f1 = server.submit(wav)
        r0 = f0.result(timeout=WAIT)
        assert r0.shape == (2, SR)
        with pytest.raises(tserving.DeadlineExceeded):
            f1.result(timeout=WAIT)
        assert server.stats_shed >= 1
        np.testing.assert_array_equal(server.separate(wav, timeout=WAIT),
                                      r0)
    finally:
        server.close()


def test_async_server_threads_stop_and_queue_drains(pair):
    """Eight client threads submitting and waiting, then close: every
    request answered, every server thread stopped."""
    server = tserving.AsyncBatchServer(_model(pair), max_batch=4,
                                       max_wait_ms=2, adaptive=True,
                                       min_batch=2)
    rng = np.random.default_rng(3)
    wavs = [_noise(SR, rng) for _ in range(4)]
    errors, answered = [], []

    def client(i):
        try:
            for k in range(3):
                answered.append(server.separate(wavs[(i + k) % 4],
                                                timeout=WAIT).shape)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    server.close()
    assert not errors and answered == [(2, SR)] * 24
    assert not any(t.is_alive() for t in threads)
    assert not server._worker.is_alive() and not server._resolver.is_alive()
    assert not server._compiler.is_alive()


def test_attention_table_outlives_other_lengths():
    """The positional table a forward read is served again, and is still
    alive, after forwards at more lengths than a bounded cache would
    keep: a captured CUDA graph reads its table and holds no reference to
    it (``test_graph_replay_after_eager_forwards_at_other_lengths`` is
    the same on the card)."""
    import gc
    import weakref
    from tdanet_tpu_torch.models.components import MultiHeadAttentionModule
    mha = MultiHeadAttentionModule(16, 8).eval()
    x = torch.zeros(1, 16, 40)
    with torch.inference_mode():
        mha(x, per_utterance=True)
        table = weakref.ref(mha._pos_enc(40, 16, x))
        for T in range(41, 141):
            mha(torch.zeros(1, 16, T), per_utterance=True)
    gc.collect()
    assert table() is not None
    assert mha._pos_enc(40, 16, x) is table()


# -- on the card ------------------------------------------------------------


def _card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tdanet_tpu_torch.models import TDANetBest
    model = TDANetBest(**{**CFG, "num_blocks": 2})
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.cuda().eval()


@pytest.mark.gpu
def test_graph_replay_equals_eager_forward():
    """One served forward replayed from its CUDA graph equals the eager
    forward on the same batch, bit for bit or at >= 100 dB."""
    from tdanet_tpu_torch.utils.timing import snr_db
    model = _card_model()
    server = tserving.AsyncBatchServer(model, max_batch=2, max_wait_ms=1)
    try:
        rng = np.random.default_rng(0)
        wavs = [_noise(SR, rng), _noise(SR - 200, rng)]
        server.prewarm(lengths=[SR])
        prog = server._fwd_cache[(server._target(SR), 2)]
        x = np.zeros((2, prog.length), np.float32)
        for row, w in enumerate(wavs):
            x[row, :len(w)] = w
        got = prog(x)
        with torch.inference_mode():
            want = model(torch.from_numpy(x).cuda(),
                         per_utterance=True).cpu().numpy()
        assert server.stats["graphs"] == 1 and prog.replays == 1
    finally:
        server.close()
    if not np.array_equal(got, want):
        assert snr_db(torch.from_numpy(want), torch.from_numpy(got)) >= 100


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["streaming", "multistream"])
def test_forward_fn_is_captured_and_replayed(engine):
    """A forward_fn is captured as the engine's graph: one segment's
    replayed estimates equal the eager forward_fn, bit for bit or at
    >= 100 dB."""
    from tdanet_tpu_torch.utils.timing import snr_db
    model = _card_model()

    def swapped(x):  # the sources in the other order
        return model(x, per_utterance=True).flip(1)

    seg = _noise(SR, np.random.default_rng(5))
    kw = dict(segment=1.0, overlap=0.25, sample_rate=SR, forward_fn=swapped)
    batch = np.zeros((1 if engine == "streaming" else 2, SR), np.float32)
    batch[0] = seg
    if engine == "streaming":
        e = tserving.StreamingSeparator(model, **kw)
        got = e.push(seg)
    else:
        e = tserving.MultiStreamSeparator(model, max_streams=2, **kw)
        e.open(0)
        e.push(0, seg)
        got = e.step()[0]
    assert e.stats == {"replays": 1, "graphs": 1}
    with torch.inference_mode():
        want = swapped(torch.from_numpy(batch).cuda())[0].cpu().numpy()
    assert got.shape == want.shape == (2, SR)
    if not np.array_equal(got, want):
        assert snr_db(torch.from_numpy(want), torch.from_numpy(got)) >= 100


@pytest.mark.gpu
def test_two_inflight_batches_of_one_bucket_keep_their_estimates():
    """Two batches of one program in flight at once (pipeline depth 2):
    each collects its own estimates, not the later replay's."""
    model = _card_model()
    prog = tserving.Program(
        lambda x: model(x, per_utterance=True), 2, 8192,
        torch.device("cuda"), pool=torch.cuda.graph_pool_handle(), slots=2)
    rng = np.random.default_rng(1)
    batches = [np.stack([_noise(8192, rng) for _ in range(2)])
               for _ in range(2)]
    tickets = [prog.launch(b) for b in batches]
    got = [prog.collect(t) for t in tickets]
    with torch.inference_mode():
        for b, g in zip(batches, got):
            want = model(torch.from_numpy(b).cuda(),
                         per_utterance=True).cpu().numpy()
            np.testing.assert_allclose(g, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
    assert np.abs(got[0] - got[1]).max() > 1e-3


@pytest.mark.gpu
def test_graph_replay_after_eager_forwards_at_other_lengths():
    """A captured program replays its own answer after eager forwards at
    80 other lengths, each with a positional table of its own and memory
    that the allocator frees and hands out again: bit for bit or at
    >= 100 dB. cuDNN's deterministic algorithms are on, since the
    decoder's transposed convolution otherwise sums in an order that
    changes from one replay to the next."""
    from tdanet_tpu_torch.utils.timing import snr_db
    model = _card_model()
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        prog = tserving.Program(lambda x: model(x, per_utterance=True), 1,
                                8192, torch.device("cuda"),
                                pool=torch.cuda.graph_pool_handle())
        x = _noise(8192, np.random.default_rng(2))[None]
        want = prog(x)
        with torch.inference_mode():
            for k in range(1, 81):
                model(torch.zeros((1, 8192 + k * model.lcm), device="cuda"),
                      per_utterance=True)
        torch.cuda.synchronize()
        got = prog(x)
    finally:
        torch.backends.cudnn.deterministic = before
    if not np.array_equal(got, want):
        assert snr_db(torch.from_numpy(want), torch.from_numpy(got)) >= 100
