"""The schedule of the backward kernel of #1 (csrc/dw_conv_glob_ln_backward.cu)
on the CPU: a float64 mirror of its tile ownership, the split of each
CTA's run into tiles kept in shared memory and tiles loaded twice, its
slot ring, and the order of every fold (per (CTA, channel tile), the
per-sample sums from them as gamma times the dy and dy xh sums, per
(sample, CTA), the final sum over samples and CTAs), held against the
plain backward and against jax.vjp of the JAX package's ConvNorm; and the
plan at the training recipe's site shapes.

The plan and the shared-memory layout are the kernel library's
(``make_plan`` and ``Cfg`` in the source); :func:`layout` and
:func:`plan_of` here are their copy for the mirror, held against the
library on the card (``test_plan_copy_matches_the_library``, ``-m gpu``).
The kernel itself runs only on a card (tests/test_torch_kernels.py,
``-m gpu``); the mirror pins what it computes where and in what order.
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch

from tdanet_tpu_torch.kernels import dw_conv_glob_ln as dw
from tdanet_tpu_torch.probes.dw_backward import step_sites

SMEM, RING, SLOTS = 232448, 3, 32  # csrc kSmemMax, kRing, kSlots
# a tile, (row groups, channels), by whether T is the innermost axis: a
# thread owns `rows` consecutive output rows of one channel (csrc Cfg)
TILE = {True: (32, 16), False: (16, 32)}


class Layout(NamedTuple):
    """csrc Cfg: an instance's tile, staged rows and shared memory."""
    tile_t: int  # output rows a tile
    tile_c: int  # channels a tile
    front: int   # staged rows before a tile's first row (dy; 0: K 1)
    ny: int      # dy rows staged a tile: front + tile_t + 8 or 0
    nx: int      # x rows staged from (t0 - front) stride - (K-1)//2
    slot: int    # bytes of a tile's slot (x lines, then dy lines)
    fixed: int   # bytes of shared memory before the slots


def layout(elem, K, stride, t_contig, rows):
    """The :class:`Layout` of the instance for x's element size ``elem``
    (4 or 2). A slot line is 16-byte aligned and one 16-byte chunk longer
    than its span (the raw copy)."""
    groups, tile_c = TILE[t_contig]
    tile_t = groups * rows
    chunk = 16 // elem
    P = (K - 1) // 2
    after = (stride - 1 + P) // stride
    front = 8 if K > 1 else 0
    ny = front + tile_t + (8 if after else 0)
    nx = -(-((ny - 1) * stride + K) // 8) * 8
    fixed = 2 * 16 * 8  # the per-sample reduction
    if t_contig:  # lines are channels; an mbarrier a (slot, warp)
        slot = tile_c * (nx + chunk + ny + chunk) * elem
        fixed += SLOTS * 16 * 8
    else:         # lines are rows; an mbarrier a slot, the dz edges, the
        slot = (nx + ny) * (tile_c + chunk) * elem  # channel reduction
        fixed += SLOTS * 8 + (2 * 17 * 3 * 32 + 16 * 32) * 4
    return Layout(tile_t, tile_c, front, ny, nx, slot, fixed)


class Plan(NamedTuple):
    """csrc make_plan: one launch's tiles, grid and residency."""
    lay: Layout
    tiles_t: int
    tiles_c: int
    per_sample: int
    n_tiles: int
    grid: int
    max_slots: int  # tile slots a CTA's shared memory holds
    segs: int       # channel tiles one CTA's run touches, at most
    smem: int       # dynamic shared memory of the launch, bytes
    kept: int       # tiles kept from phase 1 to phase 2, all CTAs
    cparts: int     # values (doubles) of the per-(CTA, channel tile) sums

    def run(self, j):
        """CTA j's tiles [lo, hi)."""
        return j * self.n_tiles // self.grid, (j + 1) * self.n_tiles // \
            self.grid

    def resident(self, j):
        """The tiles CTA j keeps from phase 1 to phase 2 (the first of its
        run): all when they fit, else the slots less the ring's."""
        lo, hi = self.run(j)
        return hi - lo if hi - lo <= self.max_slots else \
            self.max_slots - RING


def plan_of(B, T_out, C, K, stride, t_contig, elem, capacity, smem=SMEM,
            rows=None):
    """The :class:`Plan` of a launch, ``rows`` a thread from the wrapper's
    ``backward_rows`` when None; ``smem`` bytes in place of the kernel's
    227 KB send more of each run through the ring."""
    rows = rows or dw.backward_rows(T_out, stride, t_contig)
    lay = layout(elem, K, stride, t_contig, rows)
    tiles_t, tiles_c = -(-T_out // lay.tile_t), -(-C // lay.tile_c)
    N = B * tiles_t * tiles_c
    G = min(capacity, N)
    max_slots = min(SLOTS, (smem - lay.fixed) // lay.slot)
    assert max_slots >= RING
    runs = [(j * N // G, (j + 1) * N // G) for j in range(G)]
    segs = max((hi - 1) // tiles_t - lo // tiles_t + 1 for lo, hi in runs)
    longest = max(hi - lo for lo, hi in runs)
    kept = sum(hi - lo if hi - lo <= max_slots else max_slots - RING
               for lo, hi in runs)
    return Plan(lay, tiles_t, tiles_c, tiles_t * tiles_c, N, G, max_slots,
                segs, lay.fixed + min(longest, max_slots) * lay.slot, kept,
                G * segs * (K + 3) * lay.tile_c)


@pytest.fixture
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _owner(i, N, G):
    return ((i + 1) * G - 1) // N


def _slot_schedule(n, R):
    """The kernel's loads and uses of a CTA's slots, in program order:
    ("load", k, slot) and ("use", k, slot) for run index k, phase 1 then
    phase 2 (the run backwards). Resident k < R sits in slot k; the rest
    go through slots R.. R + RING - 1."""
    ev = []
    slot1 = (lambda k: k if k < R else R + (k - R) % RING)
    for k in range(min(n, R + RING)):
        ev.append(("load", k, slot1(k)))
    for k in range(n):
        ev.append(("use", k, slot1(k)))
        if k + 1 > R and k + RING < n:  # iteration k + 1 refills k's slot
            ev.append(("load", k + RING, slot1(k)))
    again = n - R
    ev.append(("barrier",))
    for m in range(min(again, RING)):
        ev.append(("load", n - 1 - m, R + m))
    for m in range(n):
        k = n - 1 - m
        if m >= 1 and m - 1 + RING < again:
            ev.append(("load", n - 1 - (m - 1 + RING), R + (m - 1) % RING))
        ev.append(("use", k, R + m % RING if m < again else k))
    return ev


def _check_slots(n, R, max_slots):
    """Replays the schedule: every use finds its tile in its slot, loaded
    in this phase or, for a kept tile, in phase 1; no load overwrites a
    kept tile or a tile still to be used in this phase; at most max_slots
    slots. Returns how many times each run index is loaded."""
    held, loads, phase = {}, [0] * n, 1
    pending = {1: set(range(n)), 2: set(range(n))}
    for e in _slot_schedule(n, R):
        if e[0] == "barrier":
            assert not pending[1]
            phase = 2
            continue
        kind, k, s = e
        assert 0 <= s < max_slots
        if kind == "load":
            if s in held:
                old, old_phase = held[s]
                assert old >= R, (n, R, e)  # never a kept tile
                assert old_phase != phase or old not in pending[phase], (
                    n, R, e)
            held[s] = (k, phase)
            loads[k] += 1
        else:
            assert held.get(s) == (k, phase if k >= R else 1), (n, R, e)
            pending[phase].remove(k)
    assert not pending[2]
    return loads


def mirror_backward(dy, x, w, b, gamma, stats, *, stride, K, capacity,
                    smem=SMEM, elem=2):
    """The kernel's gradients in float64, in its order, on the schedule
    of its instance for x's innermost axis and element size ``elem``
    (:func:`plan_of`): x (B, T, C), dy (B, T_out, C). Returns (dx,
    dweight, dbias or None, dgamma, dbeta) and the loads of every tile."""
    B, T, C = x.shape
    T_out = dy.shape[1]
    t_contig = x.stride(1) == 1
    p = plan_of(B, T_out, C, K, stride, t_contig, elem, capacity, smem)
    lay = p.lay
    TT, TCC, FH = lay.tile_t, lay.tile_c, lay.front
    P = (K - 1) // 2
    HB, HA = P // stride, (stride - 1 + P) // stride
    Q = K + 3
    G, N = p.grid, p.n_tiles
    xs, dys = x.double(), dy.double()
    wd = w.double().reshape(C, K)
    bd = torch.zeros(C, dtype=torch.float64) if b is None else b.double()
    gd = gamma.double()
    st = stats.double()

    def box(i):
        b_, r = divmod(i, p.per_sample)
        ct, tt = divmod(r, p.tiles_t)
        return b_, tt * TT, ct * TCC

    def stage(i):
        """The tile's staged x rows [rx0, rx0 + nx) and dy rows [ry0, ry0 +
        ny) of its channels, zero outside the tensors: (TCC, rows)."""
        b_, t0, c0 = box(i)
        rx0, ry0 = (t0 - FH) * stride - P, t0 - FH
        sx = torch.zeros(TCC, lay.nx, dtype=torch.float64)
        sy = torch.zeros(TCC, lay.ny, dtype=torch.float64)
        c1 = min(C, c0 + TCC)
        a, z = max(rx0, 0), min(T, rx0 + lay.nx)
        sx[:c1 - c0, a - rx0:z - rx0] = xs[b_, a:z, c0:c1].T
        a, z = max(ry0, 0), min(T_out, ry0 + lay.ny)
        sy[:c1 - c0, a - ry0:z - ry0] = dys[b_, a:z, c0:c1].T
        return sx, sy

    def rows(i, sx, sy, j0, n_rows):
        """xh and dy at dy buffer rows [j0, j0 + n_rows) of the tile's
        channels, and the x taps under them (TCC, n_rows, K)."""
        b_, t0, c0 = box(i)
        cs = torch.arange(c0, c0 + TCC).clamp(max=C - 1)
        ok = (torch.arange(c0, c0 + TCC) < C).double()[:, None]
        taps = torch.stack([sx[:, (j0 + torch.arange(n_rows)) * stride + k]
                            for k in range(K)], dim=-1)
        y = (taps * (wd[cs] * ok)[:, None, :]).sum(-1) + (bd[cs] * ok[:, 0])[
            :, None]
        xh = ((y - st[b_, 0]) - st[b_, 1]) * st[b_, 2]
        return xh, sy[:, j0:j0 + n_rows], taps, gd[cs] * ok[:, 0], ok

    parts = torch.full((B, G, 2), float("nan"), dtype=torch.float64)
    cparts = torch.full((G, p.segs, Q, TCC), float("nan"),
                        dtype=torch.float64)
    loads = []
    for j in range(G):  # phase 1
        lo, hi = p.run(j)
        loads += _check_slots(hi - lo, p.resident(j), p.max_slots)
        s12 = {}  # per sample: gamma times the channels' sums of dy, dy xh
        for i in range(lo, hi):
            b_ = i // p.per_sample
            xh, d, _, gm, _ = rows(i, *stage(i), FH, TT)
            seg = i // p.tiles_t - lo // p.tiles_t
            if i == lo or i // p.tiles_t != (i - 1) // p.tiles_t:
                cparts[j, seg, K + 1:] = 0.0
            cparts[j, seg, K + 1] += (d * xh).sum(1)
            cparts[j, seg, K + 2] += d.sum(1)
            if i == hi - 1 or i // p.tiles_t != (i + 1) // p.tiles_t:
                s1, s2 = s12.get(b_, (0.0, 0.0))
                s12[b_] = (s1 + (gm * cparts[j, seg, K + 2]).sum().item(),
                           s2 + (gm * cparts[j, seg, K + 1]).sum().item())
        for b_, (s1, s2) in s12.items():
            parts[b_, j] = torch.tensor([s1, s2], dtype=torch.float64)
    dx = torch.zeros(B, T, C, dtype=torch.float64)
    for j in range(G):  # phase 2, the run backwards
        lo, hi = p.run(j)
        for i in range(hi - 1, lo - 1, -1):
            b_, t0, c0 = box(i)
            f = b_ * p.per_sample
            js = range(_owner(f, N, G), _owner(f + p.per_sample - 1, N, G) + 1)
            A = sum(parts[b_, jj, 0].item() for jj in js) / (T_out * C)
            M = sum(parts[b_, jj, 1].item() for jj in js) / (T_out * C)
            j0 = FH - HB  # dz rows [t0 - HB, t0 + TT + HA)
            n_rows = TT + HB + HA
            xh, d, taps, gm, ok = rows(i, *stage(i), j0, n_rows)
            t = t0 - HB + torch.arange(n_rows)
            valid = ((t >= 0) & (t < T_out)).double()[None, :] * ok
            dz = st[b_, 2] * ((d * gm[:, None] - A) - xh * M) * valid
            own = slice(HB, HB + TT)
            seg = i // p.tiles_t - lo // p.tiles_t
            if i == hi - 1 or i // p.tiles_t != (i + 1) // p.tiles_t:
                cparts[j, seg, :K + 1] = 0.0
            cparts[j, seg, :K] += (dz[:, own, None] * taps[:, own]).sum(1).T
            cparts[j, seg, K] += dz[:, own].sum(1)
            c1 = min(C, c0 + TCC)
            us = torch.arange(t0 * stride, min(T, (t0 + TT) * stride))
            acc = torch.zeros(TCC, len(us), dtype=torch.float64)
            for k in range(K):  # the taps that land on input row u
                num = us + P - k
                hit = num % stride == 0
                wk = torch.zeros(TCC, dtype=torch.float64)
                wk[:c1 - c0] = wd[c0:c1, k]
                acc[:, hit] += wk[:, None] * dz[
                    :, num[hit] // stride - (t0 - HB)]
            dx[b_, us, c0:c1] = acc[:c1 - c0].T
    out = torch.zeros(Q, C, dtype=torch.float64)  # phase 3
    for c in range(C):
        ct, c2 = divmod(c, TCC)
        for q in range(Q):
            s = 0.0
            for b_ in range(B):
                grp = b_ * p.tiles_c + ct
                f = grp * p.tiles_t
                for jj in range(_owner(f, N, G),
                                _owner(f + p.tiles_t - 1, N, G) + 1):
                    seg = grp - (jj * N // G) // p.tiles_t
                    s += cparts[jj, seg, q, c2].item()
            out[q, c] = s
    return (dx, out[:K].T.reshape(C, 1, K), None if b is None else out[K],
            out[K + 1], out[K + 2]), loads


def _operands(B, T, C, K, bias, stride, t_major, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, T, C)))
    if t_major:
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    w = torch.from_numpy(rng.standard_normal((C, 1, K)) * 0.3)
    b = torch.from_numpy(rng.standard_normal(C) * 0.1) if bias else None
    g = torch.from_numpy(rng.standard_normal(C))
    T_out = (T - 1) // stride + 1
    dy = torch.from_numpy(rng.standard_normal((B, T_out, C)))
    return x, w, b, g, dy


# (T, C, K, stride, bias, T innermost, capacity, shared memory): grids of
# 1-7 CTAs, ragged T and C, K 1, 3, 5 and 7 (K 7 at stride 1: three halo
# rows of dz each side), both strides and layouts, 8 and 16 rows a thread;
# a small shared memory sends part of each run through the ring (loaded
# twice)
MIRROR_CASES = [
    (600, 40, 5, 1, True, True, 3, SMEM),
    (601, 40, 5, 2, True, True, 5, SMEM),
    (700, 24, 1, 1, False, True, 7, SMEM),
    (1100, 40, 5, 1, True, True, 2, 150000),
    (1100, 33, 5, 2, False, True, 1, 150000),
    (1100, 40, 7, 1, True, True, 3, 150000),
    (401, 24, 3, 2, True, True, 2, SMEM),
    (250, 40, 7, 1, False, True, 2, SMEM),
    (300, 40, 5, 1, False, False, 4, SMEM),
    (700, 64, 1, 1, False, False, 2, 100000),
    (333, 40, 5, 2, True, False, 6, 130000),
    (900, 40, 5, 2, True, False, 2, 130000),
    (500, 40, 7, 1, False, False, 5, 130000),
    (300, 24, 3, 1, True, False, 3, SMEM),
]


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("T,C,K,stride,bias,t_major,capacity,smem",
                         MIRROR_CASES)
def test_mirror_matches_plain_and_jax(T, C, K, stride, bias, t_major,
                                      capacity, smem):
    """The kernel's schedule in float64 gives the plain backward's
    gradients and jax.vjp's of the JAX package's ConvNorm (ops.conv1d +
    ops.glob_ln, x64) within 1e-10 of each gradient's largest magnitude;
    every tile is loaded once, or twice where it is not kept."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from tdanet_tpu import ops as jops
    B = 2
    x, w, b, g, dy = _operands(B, T, C, K, bias, stride, t_major, T + C)
    stats = dw.stats_reference(x, w, b, stride=stride, K=K)
    got, loads = mirror_backward(dy, x, w, b, g, stats, stride=stride, K=K,
                                 capacity=capacity, smem=smem)
    kept = plan_of(B, dy.shape[1], C, K, stride, t_major, 2, capacity,
                   smem).kept
    assert loads.count(1) == kept and loads.count(2) == len(loads) - kept
    want = dw.dw_conv_glob_ln_backward_reference(dy, x, w, b, g, stride=stride,
                                                 K=K, stats=stats)
    for a, r in zip(got, want):
        assert (a is None) == (r is None)
        if r is not None:
            np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=0,
                                       atol=1e-10 * r.abs().max().item())

    def convnorm(xc, w_, b_, g_, be_):
        y = jops.conv1d(xc, {"weight": w_, "bias": b_}, stride=stride,
                        padding=(K - 1) // 2, groups=C)
        return jops.glob_ln(y, {"gamma": g_, "beta": be_})

    with jax.enable_x64():
        zeros = torch.zeros(C, dtype=torch.float64)
        args = [jnp.asarray(a.numpy()) for a in (
            x.transpose(1, 2), w, b if bias else zeros, g, zeros)]
        _, vjp = jax.vjp(convnorm, *args)
        jg = vjp(jnp.asarray(dy.transpose(1, 2).numpy()))
    jg = [np.asarray(jg[0]).transpose(0, 2, 1), *map(np.asarray, jg[1:])]
    for a, r in zip([v for v in got], jg):
        if a is not None:
            np.testing.assert_allclose(a.numpy(), r, rtol=0,
                                       atol=1e-10 * np.abs(r).max())


def _site_shapes():
    """(T, K, stride, bias) of the 14 distinct site shapes of a training
    step (bias does not change the plan)."""
    return sorted(set(step_sites()))


@pytest.mark.parametrize("elem,t_contig", [(2, True), (4, True), (2, False),
                                           (4, False)])
def test_backward_plan_at_step_sites(elem, t_contig):
    """At the recipe's 14 site shapes (B 8; 132 CTAs, and 7): 16 rows a
    thread only where that instance exists (stride 1, T innermost); the
    CTAs' runs cover the tiles once, in order; the shared memory asked for
    is the fixed part and a slot for each tile of the longest run up to
    the slots, never more than a CTA may take; a run keeps all its tiles
    when they fit and otherwise leaves the ring's three slots, and its
    slot schedule holds; the parts a CTA writes fit its segments."""
    assert len(_site_shapes()) == 14
    for T, K, stride, _ in _site_shapes():
        T_out = (T - 1) // stride + 1
        rows = dw.backward_rows(T_out, stride, t_contig)
        assert rows == 8 or (rows == 16 and stride == 1 and t_contig)
        for capacity in (132, 7):
            p = plan_of(8, T_out, 512, K, stride, t_contig, elem, capacity)
            lay = p.lay
            assert (lay.tile_t, lay.tile_c) == (TILE[t_contig][0] * rows,
                                                TILE[t_contig][1])
            assert p.grid == min(capacity, p.n_tiles)
            runs = [p.run(j) for j in range(p.grid)]
            assert [i for lo, hi in runs for i in range(lo, hi)] == list(
                range(p.n_tiles))
            longest = max(hi - lo for lo, hi in runs)
            assert p.smem == lay.fixed + min(longest, p.max_slots) * lay.slot
            assert lay.fixed + p.max_slots * lay.slot <= SMEM
            assert RING <= p.max_slots <= SLOTS
            for j, (lo, hi) in enumerate(runs):
                R = p.resident(j)
                assert R == (hi - lo if hi - lo <= p.max_slots
                             else p.max_slots - RING)
                assert (hi - 1) // p.tiles_t - lo // p.tiles_t < p.segs
                _check_slots(hi - lo, R, p.max_slots)
            assert p.kept == sum(p.resident(j) for j in range(p.grid))


@pytest.mark.gpu
def test_plan_copy_matches_the_library():
    """:func:`plan_of`, the mirror's copy of the plan, is the kernel
    library's (``dw_conv_glob_ln_backward_plan``) at every instance
    (storage, K 1/3/5/7, stride, layout, 8 or 16 rows) on small shapes
    (runs of one and two tiles, runs past the slots) and at the recipe's
    14 step site shapes in both storages and layouts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import ctypes
    lib = dw._backward_library()

    def library(x_bf16, K, stride, t_contig, rows, B, T_out, C, cap):
        out = (ctypes.c_longlong * len(dw.BackwardPlan._fields))()
        assert lib.dw_conv_glob_ln_backward_plan(
            x_bf16, K, stride, int(t_contig), rows, B, T_out, C, cap,
            out) == 0
        return dw.BackwardPlan(*out)

    def check(x_bf16, K, stride, t_contig, rows, B, T_out, C, cap):
        got = library(x_bf16, K, stride, t_contig, rows, B, T_out, C, cap)
        p = plan_of(B, T_out, C, K, stride, t_contig, 2 if x_bf16 else 4,
                    cap, rows=rows)
        want = (p.lay.tile_t, p.lay.tile_c, p.lay.slot, p.lay.fixed,
                p.n_tiles, p.grid, p.max_slots, p.segs, p.smem, p.kept,
                p.cparts)
        assert tuple(got) == want, (x_bf16, K, stride, t_contig, rows, B,
                                    T_out, C, cap)

    for x_bf16 in (0, 1):
        for K in (1, 3, 5, 7):
            for stride in (1, 2):
                for t_contig in (False, True):
                    for rows in ((8, 16) if (stride, t_contig) == (1, True)
                                 else (8,)):
                        for B, T_out, C, cap in ((1, 100, 16, 132),
                                                 (2, 700, 40, 3),
                                                 (8, 3010, 512, 132),
                                                 (8, 189, 512, 5)):
                            check(x_bf16, K, stride, t_contig, rows, B,
                                  T_out, C, cap)
    for T, K, stride, _ in _site_shapes():
        T_out = (T - 1) // stride + 1
        for x_bf16 in (0, 1):
            for t_contig in (False, True):
                check(x_bf16, K, stride, t_contig,
                      dw.backward_rows(T_out, stride, t_contig), 8, T_out,
                      512, 132)
