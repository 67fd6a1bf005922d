"""The plain versions of the port's micro-kernels against the arithmetic of
the Pallas bodies in scripts/probe_mosaic_ops.py and probe_mosaic_ops2.py,
written out in ``jax.numpy`` (the scripts' kernels are closures of
``main()`` and their ``run`` has no interpret mode, so they cannot be
called off a TPU). The scripts' quirks are part of the arithmetic: a
chunked loop covers whole chunks only, and the chunked statistics divide
by R * C. Rows a body never writes are undefined in the scripts; the port
writes zeros there, and only the written rows are compared. Each test names
the script lines it restates, and ``test_script_lines`` holds the lines that
carry a quirk against the scripts' text, so a change there shows here.

On the CPU a wrapper is its plain version; the CUDA kernels are held
against the plain versions on a card only:
    python -m pytest --noconftest tests/test_torch_micro_ops.py -m gpu
"""
import os

import numpy as np
import pytest
import torch

from tdanet_tpu_torch.kernels import micro_ops as mo

# small stand-ins for the scripts' (24, 2032, 512): R leaves the taps'
# 10 extra input rows and holds one whole chunk of 512 and four of 128
B, R, C = 2, 600, 64
RD = 296


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: parallel test workers would otherwise
    oversubscribe the cores (each op's parallel region waiting for threads
    the other workers hold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, R, C)).astype(np.float32)
    w = rng.standard_normal((8, C)).astype(np.float32)
    dec = rng.standard_normal((RD, R)).astype(np.float32)
    wp = rng.standard_normal((mo.PROJ_K, C)).astype(np.float32)
    return x, w, dec, wp


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def _jnp():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax import lax
    return jnp, lax


def _same(got, want, rows, tol_ulps=0):
    """``got`` (torch bf16) equals ``want`` (jax bf16) on ``rows`` up to
    ``tol_ulps`` bf16 steps (2**-7 relative each), and is zero on every other row."""
    got = got.float().numpy()
    want = np.asarray(want.astype("float32"))
    rest = np.ones(got.shape[1], bool)
    rest[rows] = False
    assert not got[:, rest].any()
    a, b = got[:, rows], want[:, rows]
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=tol_ulps * 2.0 ** -7,
                               atol=tol_ulps * 1e-6)


SCRIPTS = os.path.join(os.path.dirname(__file__), os.pardir, "scripts")


@pytest.mark.parametrize("script,line,text", [
    ("probe_mosaic_ops.py", 71, "lax.slice_in_dim(h, 6 + k, 6 + k + 2010"),
    ("probe_mosaic_ops.py", 75, "jnp.pad(acc, ((8, R - 2010 - 8), (0, 0)))"),
    ("probe_mosaic_ops.py", 82, "wb = w_ref[:].astype(jnp.bfloat16)"),
    ("probe_mosaic_ops.py", 95, "jnp.pad(y, ((0, R - RD), (0, 0)))"),
    ("probe_mosaic_ops.py", 109, "mean = s / (R * C)"),
    ("probe_mosaic_ops.py", 125, "lax.slice_in_dim(x_ref[0], 0, 1005"),
    ("probe_mosaic_ops2.py", 71, "o_ref[0, 8:2024] = acc"),
    ("probe_mosaic_ops2.py", 79, "win = x_ref[0, pl.ds(start, CH + 16), :]"),
    ("probe_mosaic_ops2.py", 88, "lax.fori_loop(0, 2016 // CH, body, 0)"),
    ("probe_mosaic_ops2.py", 96, "t = x_ref[0, pl.ds(start, CH), :128]"),
    ("probe_mosaic_ops2.py", 100, "lax.fori_loop(0, R // CH, body, 0)"),
    ("probe_mosaic_ops2.py", 117, "lax.fori_loop(0, R // CH, pa, (0.0, 0.0))"),
    ("probe_mosaic_ops2.py", 118, "mean = s / (R * C)"),
])
def test_script_lines(script, line, text):
    """The script lines that the tests below restate say what they said."""
    with open(os.path.join(SCRIPTS, script)) as f:
        assert text in f.read().splitlines()[line - 1]


def test_copy():
    """probe_mosaic_ops.py:63, probe_mosaic_ops2.py:59."""
    x = _bf16(_operands()[0])
    assert torch.equal(mo.copy(x), x)


@pytest.mark.parametrize("rows,chunk,acc", [
    (580, 0, "float32"), (580, 0, "bfloat16"),   # script 1: pad form
    (590, 0, "float32"),                          # script 2: sliced store
    (590, 512, "float32"), (590, 128, "float32")])
def test_taps(rows, chunk, acc):
    """probe_mosaic_ops.py:67-76 (fp32 sums) and :80-88 (bf16);
    probe_mosaic_ops2.py:63-71 (whole) and :76-88 (chunked: ``body`` below
    is :79-86 on a CH + 16 row window, the loop :88)."""
    jnp, lax = _jnp()
    x, w, _, _ = _operands(1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wj = jnp.asarray(w)
    n = rows if chunk == 0 else rows // chunk * chunk

    def body(h, count):
        total = None
        for k in range(5):
            t = lax.slice_in_dim(h, 6 + k, 6 + k + count, axis=0)
            if acc == "float32":
                term = t.astype(jnp.float32) * wj[k][None, :]
            else:
                term = t * wj.astype(jnp.bfloat16)[k][None, :]
            total = term if total is None else total + term
        return total.astype(jnp.bfloat16)

    want = np.zeros((B, R, C), np.float32)
    for b in range(B):
        if chunk == 0:
            want[b, 8:8 + n] = np.asarray(body(xb[b], n).astype(jnp.float32))
        else:
            for ci in range(rows // chunk):  # whole chunks only
                win = xb[b, ci * chunk:ci * chunk + chunk + 16]
                want[b, ci * chunk + 8:ci * chunk + 8 + chunk] = np.asarray(
                    body(win, chunk).astype(jnp.float32))
    got = mo.taps(_bf16(x), torch.from_numpy(w), rows=rows,
                  acc=getattr(torch, acc), chunk=chunk)
    # fp32 sums may associate differently: one bf16 step after rounding
    _same(got, jnp.asarray(want), slice(8, 8 + n), tol_ulps=1)
    assert n == {(580, 0): 580, (590, 0): 590, (590, 512): 512,
                 (590, 128): 512}[(rows, chunk)]


@pytest.mark.parametrize("operands", ["float32", "bfloat16"])
def test_decimate(operands):
    """probe_mosaic_ops.py:92-95 (fp32 operands) and :99-102 (bf16)."""
    jnp, _ = _jnp()
    x, _, dec, _ = _operands(2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    d = jnp.asarray(dec).astype(getattr(jnp, operands))
    want = jnp.stack([jnp.pad(
        jnp.dot(d, xb[b].astype(d.dtype),
                preferred_element_type=jnp.float32),
        ((0, R - RD), (0, 0))).astype(jnp.bfloat16) for b in range(B)])
    got = mo.decimate(_bf16(x), torch.from_numpy(dec).to(
        getattr(torch, operands)))
    _same(got, want, slice(0, RD), tol_ulps=1)


@pytest.mark.parametrize("chunk", [0, 512])
def test_stats_normalize(chunk):
    """probe_mosaic_ops.py:106-111 (whole); probe_mosaic_ops2.py:111-125
    (sums over R // 512 whole chunks, :117, divided by R * C, :118-119)."""
    jnp, lax = _jnp()
    x = _operands(3)[0] * 2 + 0.5
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    n = R if chunk == 0 else R // chunk * chunk
    outs = []
    for b in range(B):
        y = xb[b, :n].astype(jnp.float32)
        s, ss = jnp.sum(y), jnp.sum(y * y)
        mean = s / (R * C)  # R * C even when only n rows were summed
        rstd = lax.rsqrt(ss / (R * C) - mean * mean + 1e-8)
        outs.append(jnp.pad(((y - mean) * rstd).astype(jnp.bfloat16),
                            ((0, R - n), (0, 0))))
    got = mo.stats_normalize(_bf16(x), chunk=chunk)
    _same(got, jnp.stack(outs), slice(0, n), tol_ulps=1)


@pytest.mark.parametrize("chunk,width", [(0, 128), (0, 192), (512, 192),
                                         (128, 192)])
def test_proj(chunk, width):
    """width 128: script 1's separate (B, R, 128) operand; above: script
    2's x[..., :128] slice of a wider tensor. probe_mosaic_ops.py:117-120;
    probe_mosaic_ops2.py:93-100 (chunked) and :104-107 (whole)."""
    jnp, _ = _jnp()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, R, width)).astype(np.float32)
    wp = _operands(4)[3]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(wp).astype(jnp.bfloat16)
    n = R if chunk == 0 else R // chunk * chunk
    want = jnp.stack([jnp.pad(
        jnp.dot(xb[b, :n, :128], wb, preferred_element_type=jnp.float32)
        .astype(jnp.bfloat16), ((0, R - n), (0, 0))) for b in range(B)])
    got = mo.proj(_bf16(x), _bf16(wp), chunk=chunk)
    assert got.shape == (B, R, C)
    _same(got, want, slice(0, n), tol_ulps=1)


def test_repeat2():
    """probe_mosaic_ops.py:124-127."""
    jnp, lax = _jnp()
    x = _operands(5)[0]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jnp.stack([jnp.pad(
        jnp.repeat(lax.slice_in_dim(xb[b], 0, 290, axis=0), 2, axis=0),
        ((0, R - 580), (0, 0))) for b in range(B)])
    _same(mo.repeat2(_bf16(x), 290), want, slice(0, 580))


def test_rejections():
    x = _bf16(_operands()[0])
    w = torch.zeros(8, C)
    with pytest.raises(TypeError, match="bf16"):
        mo.copy(x.float())
    with pytest.raises(ValueError, match="multiple of 64"):
        mo.copy(x[:, :, :40])
    with pytest.raises(ValueError, match="chunk"):
        mo.taps(x, w, chunk=64)
    with pytest.raises(ValueError, match="acc"):
        mo.taps(x, w, rows=580, acc=torch.bfloat16, chunk=128)
    with pytest.raises(ValueError, match="input rows"):
        mo.taps(x, w, rows=R)
    with pytest.raises(ValueError, match="dec must be"):
        mo.decimate(x, torch.zeros(RD, R + 1))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        mo.decimate(x, torch.zeros(RD, R, dtype=torch.float64))
    with pytest.raises(ValueError, match="w must be"):
        mo.proj(x, torch.zeros(64, C, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="chunk"):
        mo.stats_normalize(x, chunk=128)
    with pytest.raises(ValueError, match="do not fit"):
        mo.repeat2(x, 301)
    # what the TMA-fed products cannot take: a base or a stride that is not
    # a multiple of 16 bytes, an R that is not a multiple of 8, a weight too
    # wide for one SM's shared memory
    wp = torch.zeros(mo.PROJ_K, C, dtype=torch.bfloat16)
    wide = torch.zeros(B, R, 200, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        mo.proj(wide[:, :, 4:196], wp)
    with pytest.raises(ValueError, match="16-byte boundary"):
        mo.copy(torch.zeros(B * R * C + 4, dtype=torch.bfloat16)[4:]
                .view(B, R, C))
    with pytest.raises(ValueError, match="strides"):
        mo.proj(torch.zeros(B, R, 196, dtype=torch.bfloat16)[:, :, :192], wp)
    with pytest.raises(ValueError, match="multiple of 8"):
        mo.decimate(x[:, :R - 4], torch.zeros(RD, R - 4))
    with pytest.raises(ValueError, match="w must be"):
        mo.proj(x, torch.zeros(mo.PROJ_K, mo.PROJ_MAX_C + 64,
                               dtype=torch.bfloat16))
    # a view with any channel stride is copied first, then taken
    assert mo.proj(torch.zeros(B, 192, R, dtype=torch.bfloat16)
                   .transpose(1, 2), wp).shape == (B, R, C)


@pytest.mark.parametrize("width,first", [(128, 0), (136, 8), (192, 64)])
def test_proj_takes_aligned_views(width, first):
    """What the in-place read allows: a channel window of a wider tensor
    whose offset and strides are multiples of 8 elements (16 bytes)."""
    rng = np.random.default_rng(6)
    wide = _bf16(rng.standard_normal((B, R, width)).astype(np.float32))
    wp = _bf16(_operands(6)[3])
    view = wide[:, :, first:]
    got = mo.proj(view, wp, chunk=128)
    want = mo.proj_reference(view.contiguous(), wp, chunk=128)
    assert torch.equal(got, want)


@pytest.mark.parametrize("probe,index", [
    (p, i) for p in ("mosaic_ops", "mosaic_ops2") for i in range(8)])
def test_library_call_computes_the_variant(probe, index):
    """The one PyTorch call a probe times beside a variant computes the
    variant's rows (a depthwise conv gives them as (B, C, rows)): SNR >=
    35 dB against the plain version, bf16 against bf16. The chunked
    statistics have no such call (their divisor is the script's quirk)."""
    import importlib

    from tdanet_tpu_torch.probes import mosaic_ops
    from tdanet_tpu_torch.utils.timing import snr_db
    module = importlib.import_module(f"tdanet_tpu_torch.probes.{probe}")
    v = module.variants(*mosaic_ops.inputs(batch=1, device="cpu"))[index]
    if v.library is None:
        assert "stats" in v.name and "chunk 512" in v.name
        return
    want = v.plain()[:, v.rows]
    got = v.library()
    if got.shape != want.shape:
        got = got.transpose(1, 2)
    assert got.shape == want.shape
    assert snr_db(want, got) >= 35.0


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tdanet_tpu_torch.probes import mosaic_ops, mosaic_ops2
    torch.backends.cuda.matmul.allow_tf32 = False
    operands = mosaic_ops.inputs(batch=3)
    before = sum(w.launches for w in mo.WRAPPERS)
    n = 0
    with torch.inference_mode():
        for probe in (mosaic_ops, mosaic_ops2):
            for v in probe.variants(*operands):
                mosaic_ops.check(v)
                n += 1
    assert n == 16
    assert sum(w.launches for w in mo.WRAPPERS) - before == n
    # the products at a small odd shape: M, K and R no multiples of a tile
    # (128 x 256 x 64), a strided a, a width below one column tile
    gen = torch.Generator().manual_seed(1)
    for Bs, Rs, Cs, Ms in ((2, 600, 320, 296), (3, 264, 64, 130)):
        x = torch.randn(Bs, Rs, Cs, generator=gen).bfloat16().cuda()
        dec = torch.randn(Ms, Rs, generator=gen).cuda()
        wp = torch.randn(mo.PROJ_K, Cs, generator=gen).bfloat16().cuda()
        a = torch.randn(Bs, Rs, 192, generator=gen).bfloat16().cuda()
        pairs = [(mo.decimate(x, d), mo.decimate_reference(x, d), Ms)
                 for d in (dec, dec.bfloat16())]
        pairs += [(mo.proj(a, wp, chunk=ch),
                   mo.proj_reference(a, wp, chunk=ch),
                   Rs if ch == 0 else Rs // ch * ch) for ch in (0, 512, 128)]
        torch.cuda.synchronize()
        for got, want, rows in pairs:
            assert not got[:, rows:].count_nonzero().item()
            if rows:
                assert mosaic_ops.snr_db(want[:, :rows], got[:, :rows]) >= 40
