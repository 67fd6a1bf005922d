"""Phases 24 and 25 of ``chip_smoke.py``: the EMCAD-era TDANet family
(``models/tdanet_emcad.py``, 22 classes over ``emcad.py`` and
``transxnet.py``) on the card.

    python -m tdanet_tpu_torch.probes.era [--out record.json]
    python -m tdanet_tpu_torch.probes.era --precision  # the study alone
    python -m tdanet_tpu_torch.probes.era --operands   # its #1 check alone

Phase 24 (:func:`drive_family`), from #1's launch counts at 0: each class
at the widths of ``configs/tdanet_origin.yml`` (out 128, in 512, 16
blocks, depth 5, 4 ms encoder, 2 sources) at 16 kHz, ``feat_len`` the
frames of a 2 s clip as ``separate`` pads it (32768 samples: 2058),
seeded random weights, saved as a reference-format ``.pth`` and read back
with ``from_pretrain``. Each model first runs its forward once with #1
replaced by its plain version, which records the site shapes (with their
channels and eps: MSDC's convs run at the expanded width, EMCAD's norms
at eps 1e-5); every shape not yet held against plain is checked (phase
3's limit); then ``separate`` on the 2 s clip runs the kernel, its sites
recorded and all among those checked, #1's launches exactly
``SITES[name]`` x 16 a forward. TDANetEMCADv1_6's output is held against
the same model in float64 on the CPU at ``GRAD_BLOCKS`` blocks (the same
``.pth``; >= 90 dB; the 16-block CPU forward, 22 s, is cut for the time
limit of ``chip_smoke.py``); the other
21 load the same ``.pth`` at 2 blocks (the weights are shared across
blocks) and run ``separate`` on the card through #1 and through the plain
path: >= 60 dB (their float64 parity with the JAX package is the CPU
tests'; ``chip_smoke.py``'s time limit took the CPU references).
TDANetEMCADv1_6 B=1 2 s fp32 is then timed, eager and replayed from a
CUDA graph, and a profiled window of replays counts #1's device kernels
(asserted: 352 a replay), #1's share of device time and the top kernels,
cuDNN's grouped convolutions among them.

Phase 25 (:func:`drive_family_training`): TDANetEMCADv1_6 at the
recipe's widths (8 kHz) and ``GRAD_BLOCKS`` of its 16 blocks (the
float64 step of 16 blocks, 73 s of the CPU, is cut to 4 for the time
limit of ``chip_smoke.py``; the sites a block are the same),
B=2 1 s fp32, every parameter's gradient against
CPU float64 taken at the card step's side of every activation kink
(>= 50 dB; ``train_step.Kinks``: an element within rounding of a PReLU's
kink moves every gradient upstream of it, so plain float64 is no
reference an fp32 step can meet) with #1's launches per step exact under
each checkpoint policy (``train_step.check_gradients``); #1's forward
and backward at every site's own operands in that step, against float64
beside its plain version in fp32 (:func:`check_step_operands`, within
``SITE_MARGIN_DB`` of plain); ``audio_train`` on
``configs/tdanet.yml`` with the model swapped for TDANetEMCADv1_6 (a
config written to the temp dir, ``feat_len`` for the 3 s segment), on
phase 16's data: 2 epochs and a resume, #1's forward and backward
launches exact over the run, ``best_model.pth`` through ``from_pretrain``
equal to the trained model; the train step at B=8 3 s bf16 as
``audio_train`` builds it (remat "scales", which checkpoints the era
block whole: its JAX class tags no landmark), its peak memory
and exact launches. Every #1 launch of the phase is recorded and each
site shape held against plain afterwards, forward and backward, at its
channels and eps (:func:`check_training_sites`). Every line with a time
carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tdanet_tpu_torch import models
from tdanet_tpu_torch.kernels import _build
from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_backward,
    dw_conv_glob_ln_backward_reference, dw_conv_glob_ln_reference,
    forward_with_stats)
from tdanet_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
from tdanet_tpu_torch.models import BaseModel, components, feat_len_for
from tdanet_tpu_torch.probes import dw_backward, train_step
from tdanet_tpu_torch.probes.train_step import tone_mix
from tdanet_tpu_torch.probes.variants import (
    card_sites, cpu64_snr, plain_sites, profile_graph)
from tdanet_tpu_torch.utils import separate
from tdanet_tpu_torch.utils.parser import load_yaml, save_yaml
from tdanet_tpu_torch.utils.timing import (
    card_line, cuda_time, graph_time, snr_db)

SR = 16000
SECONDS = 2.0
PADDED = 32768  # 2 s at 16 kHz on the models' 1024-sample lattice
# configs/tdanet_origin.yml's widths at 16 kHz, feat_len of the padded clip
CFG = dict(out_channels=128, in_channels=512, num_blocks=16,
           upsampling_depth=5, enc_kernel_size=4, num_sources=2,
           sample_rate=SR, feat_len=feat_len_for(PADDED, 4, SR))
# #1's sites a block iteration at in 512 and depth 5, from the code: the
# conv pyramid 5 (DOWN "conv"); each LA 3, each LAOpt1-3 1, LAOpt4-5 0
# (4 last layers); an EMCAD decoder 4 EUCB + 3 a kept MSCB (MSDC's K
# 1/3/5); OSRA's sr K1 conv 1 (TDANetMSFFN); TDANetEMCADF1 has no LA
SITES = {
    "TDANetEMCADv1_6": 22, "TDANetEMCAD_v1": 31, "TDANetEMCADv1_3": 31,
    "TDANetEMCADv1_4": 28, "TDANetEMCADv1_5": 31,
    "TDANetEMCADv1_6_Final": 22, "TDANetEMCADv1_6_noIDConv": 27,
    "TDANetEMCADv1_6_FCDyConv": 22, "TDANetEMCADv1_6_LAOpt1": 14,
    "TDANetEMCADv1_6_noASG": 22, "TDANetEMCADv1_6_noCBAM": 22,
    "TDANetEMCADv1_6_noMMLP": 16, "TDANetEMCADv1_6_noCBAM_laopt3": 14,
    "TDANetEMCADv1_6_noCBAM_laopt4": 10, "TDANetEMCADv1_6_noCBAM_laopt5": 10,
    "TDANetEMCAD": 36, "TDANetEMCADF1": 24, "TDANetDynamicDownsample": 12,
    "TDANetGateOSRA": 17, "TDANetChannelFusion": 4, "TDANetMSFFN": 18,
    "TDANetTranXNet": 17}
FLAGSHIP = "TDANetEMCADv1_6"
CHECK_BLOCKS = 2  # the other 21 against the card's plain path here
GRAD_BLOCKS = 4  # of 16: the CPU float64 references of phases 24 and 25
TRAIN_CONF = "configs/tdanet.yml"
TRAIN_UTTERANCES, VALID_UTTERANCES = 16, 8
PROFILED_REPLAYS = 3
LIMIT_DB, GRAD_LIMIT_DB = 90.0, 50.0
PLAIN_LIMIT_DB = 60.0  # against the card's plain path (phase 22's limit)
# #1 at the step's own operands, against float64: its lowest SNR at a
# site shape at most this far below its plain fp32 version's
SITE_MARGIN_DB = 6.0
FP32, BF16 = "torch.float32", "torch.bfloat16"


def _expect(ok, what):
    if not ok:
        raise AssertionError(what)


def site_key(x, K, stride, bias, eps=1e-8):
    """What a #1 launch of this family is, for the checks: (B, T, C, K,
    stride, bias, T innermost, dtype, eps)."""
    B, T, C = x.shape
    return (B, T, C, K, stride, bias, x.stride(1) == 1, str(x.dtype), eps)


def check_forward(keys, what, seed=0):
    """#1 against its plain version at every site of ``keys`` (each at its
    channels, eps and layout: T innermost, the model's (B, C, T), or C
    innermost, as a head-merged attention output reaches an LA), on
    seeded operands made on the card, fp32 parameters as the models pass
    them: fp32 at phase 3's limit (max|d| <= 1e-4 max|ref|), bf16 x >= 40
    dB against plain in fp32 on the same bf16 values."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    worst, low, t0 = 0.0, float("inf"), time.perf_counter()
    odd = {k for k in keys if k[7] not in (FP32, BF16)}
    _expect(not odd, f"{what}: #1 ran at sites no check covers: {odd}")
    with torch.inference_mode():
        for B, T, C, K, stride, bias, t_inner, dtype, eps in sorted(keys):
            x = randn(B, C, T).transpose(1, 2) if t_inner \
                else randn(B, T, C)
            if dtype == BF16:
                x = x.bfloat16()
            ps = (randn(C, 1, K) * 0.2, randn(C) * 0.1 if bias else None,
                  randn(C), randn(C))
            kw = dict(stride=stride, K=K, eps=eps)
            got = dw_conv_glob_ln(x, *ps, **kw)
            ref = dw_conv_glob_ln_reference(x.float(), *ps, **kw)
            if dtype == FP32:
                err = (got - ref).abs().max().item()
                lim = 1e-4 * ref.abs().max().item()
                site = (B, T, C, K, stride, bias, eps)
                _expect(err <= lim, f"#1 disagrees with plain at {site}: "
                                    f"{err:.3e} > {lim:.3e}")
                worst = max(worst, err / lim)
            else:
                low = min(low, snr_db(ref, got.float()))
                _expect(low >= 40.0, f"#1 bf16 at {B, T, C, K, stride}: "
                                     f"{low:.1f} dB")
    torch.cuda.synchronize()
    worse = [f"fp32 max|d| at most {worst:.3f} of the limit"] \
        if any(k[7] == FP32 for k in keys) else []
    worse += [f"bf16 SNR at least {low:.1f} dB"] \
        if any(k[7] == BF16 for k in keys) else []
    print(f"  #1 against plain at the {len(keys)} {what} site shapes (C "
          f"{sorted({k[2] for k in keys})}, T {sorted({k[1] for k in keys})}"
          f", eps {sorted({k[8] for k in keys})}, "
          f"{sum(not k[6] for k in keys)} C-innermost): "
          f"{', '.join(worse)}; {time.perf_counter() - t0:.2f} s wall",
          flush=True)


def check_training_sites(keys, checked, what):
    """#1's forward and backward against plain at every site of ``keys``
    not in ``checked``, which then holds them: the forward as
    :func:`check_forward`, the backward as phase 14 holds it (fp32:
    every gradient's max|d| <= 1e-4 of plain's max; bf16: >= 40 dB; a
    rerun and a graph replay bit-equal), each at its channels and eps."""
    new = keys - checked
    check_forward(new, what)
    odd = {k for k in new if not k[6]}
    _expect(not odd, f"{what}: #1's backward ran at sites no check covers: "
                     f"{sorted(odd)}")
    gen = torch.Generator().manual_seed(23)
    t0 = time.perf_counter()
    for B, T, C, K, stride, bias, _, dtype, eps in sorted(new):
        dw_backward.check_site(B, T, K, stride, bias, gen,
                               torch.float32 if dtype == FP32
                               else torch.bfloat16, C=C, eps=eps)
    torch.cuda.synchronize()
    print(f"  #1's backward against plain at the {len(new)} {what} site "
          f"shapes: within the limits, rerun and replay bit-equal; "
          f"{time.perf_counter() - t0:.2f} s wall", flush=True)
    checked |= new


def capture_step(model, loss_fn, mix, src):
    """One forward and backward of ``model`` (no checkpointing) with every
    #1 site's operands kept as the step gave them. Returns ({name:
    gradient}, [(x, (weight, bias, gamma, beta), stride, K, eps, dy)]),
    dy the gradient that reached the site's output, in its layout."""
    sites, fn = [], components.dw_conv_glob_ln

    def record(x, weight, bias, gamma, beta, *, stride=1, K=5, eps=1e-8):
        out = fn(x, weight, bias, gamma, beta, stride=stride, K=K, eps=eps)
        site = [x.detach().clone(), tuple(
            None if p is None else p.detach().clone()
            for p in (weight, bias, gamma, beta)), stride, K, eps, None]
        sites.append(site)

        def keep(g):
            site[5] = (g.transpose(1, 2).contiguous().transpose(1, 2)
                       if x.stride(1) == 1 else g.contiguous())
        out.register_hook(keep)
        return out

    components.dw_conv_glob_ln = record
    try:
        _, grads = train_step.loss_and_grads(model, loss_fn, mix, src)
    finally:
        components.dw_conv_glob_ln = fn
    _expect(all(s[5] is not None for s in sites),
            "a #1 site's output got no gradient")
    return grads, [tuple(s) for s in sites]


OUTPUTS = ("out", "dx", "dweight", "dbias", "dgamma", "dbeta")


def site_precision(x, params, stride, K, eps, dy):
    """#1 (forward and backward kernels) and its plain version in x's
    dtype, each against the plain version in float64, at one site's
    operands: {output: (kernel SNR, plain SNR)} in dB."""
    w, b, g, be = params
    kw = dict(stride=stride, K=K)
    d = lambda t: None if t is None else t.double()  # noqa: E731
    with torch.no_grad():
        out, stats = forward_with_stats(x, w, b, g, be, eps=eps, **kw)
        kern = (out, *dw_conv_glob_ln_backward(dy, x, w, b, g, stats, **kw))
        plain = (dw_conv_glob_ln_reference(x, *params, eps=eps, **kw),
                 *dw_conv_glob_ln_backward_reference(dy, x, w, b, g,
                                                     eps=eps, **kw))
        ref = (dw_conv_glob_ln_reference(d(x), *map(d, params), eps=eps,
                                         **kw),
               *dw_conv_glob_ln_backward_reference(
                   d(dy), d(x), d(w), d(b), d(g), eps=eps, **kw))
    return {n: (snr_db(r, k), snr_db(r, p))
            for n, r, k, p in zip(OUTPUTS, ref, kern, plain)
            if r is not None}


def check_step_operands(sites, what):
    """:func:`site_precision` at every captured site (``capture_step``),
    printed by site shape: the lowest kernel and plain SNR of each output
    over the block iterations and the widest gap between the two at one
    site. The kernel's lowest must come within SITE_MARGIN_DB of the
    plain fp32 version's lowest, output by output and shape by shape.
    Returns {shape: {output: (lowest kernel, lowest plain, widest
    gap)}}."""
    t0, by_shape = time.perf_counter(), {}
    for site in sites:
        x, params, stride, K, eps = site[:5]
        shape = (*x.shape, K, stride, params[1] is not None, eps)
        by_shape.setdefault(shape, []).append(site_precision(*site))
    table, bad = {}, []
    for shape, rows in sorted(by_shape.items()):
        table[shape] = {}
        for n in rows[0]:
            kern = [r[n][0] for r in rows]
            plain = [r[n][1] for r in rows]
            gap = max(p - k for k, p in zip(kern, plain))
            table[shape][n] = (min(kern), min(plain), gap)
            if min(kern) < min(plain) - SITE_MARGIN_DB:
                bad.append((shape, n, round(min(plain) - min(kern), 2)))
        print(f"  {shape} x{len(rows)}: " + "; ".join(
            f"{n} {k:.1f}/{p:.1f}" + (f" (gap {g:.1f})" if g > 3 else "")
            for n, (k, p, g) in table[shape].items()), flush=True)
    print(f"{what}: #1 and plain fp32 against float64 at the {len(sites)} "
          f"sites' own operands ({len(by_shape)} shapes; kernel/plain "
          f"lowest SNR in dB); {time.perf_counter() - t0:.1f} s wall")
    _expect(not bad, f"{what}: #1 more than {SITE_MARGIN_DB} dB below "
                     f"plain fp32 at {bad[:6]}")
    return table


class _Sites:
    """The site keys held against plain so far, and #1's launches on the
    main path (checks excluded)."""

    def __init__(self):
        self.checked, self.launches = set(), 0

    def check_then_run(self, fn, what):
        """fn() once on the plain path to find its sites, the new ones held
        against plain, then fn() on the kernel with its launches recorded.
        Returns (kernel output, plain output, #1 launches of the run)."""
        with torch.inference_mode(), plain_sites(site_key) as keys:
            plain = fn()
        new = keys - self.checked
        if new:
            check_forward(new, what)
            self.checked |= new
        before = dw_conv_glob_ln.launches
        with torch.inference_mode(), card_sites(site_key) as seen:
            out = fn()
        torch.cuda.synchronize()
        n = dw_conv_glob_ln.launches - before
        self.launches += n
        missing = seen - self.checked
        _expect(not missing, f"{what} ran #1 at sites not held against "
                             f"plain: {sorted(missing)}")
        return out, plain, n


def build(name, seed, tmp, **over):
    """The class at full width with seeded random weights, through the
    user's path: serialize -> .pth -> from_pretrain -> the card. Returns
    (model, path of the .pth)."""
    model = models.get(name)(**{**CFG, **over})
    model.reset_parameters(torch.Generator().manual_seed(seed))
    path = os.path.join(tmp, f"{name}.pth")
    torch.save(model.serialize(), path)
    return BaseModel.from_pretrain(path).cuda(), path


def drive_family(card, tmp):
    """Phase 24. Returns the record (per class: launches, SNR against
    float64; the flagship's times and profile) and #1's main-path
    launches."""
    sites = _Sites()
    dw_conv_glob_ln.launches = 0
    rec = {}
    for i, name in enumerate(SITES):
        t0 = time.perf_counter()
        model, path = build(name, seed=200 + i, tmp=tmp)
        wav = tone_mix(SECONDS, seed=50 + i)
        est, _, n = sites.check_then_run(lambda: separate(model, wav),
                                         f"{name} B=1")
        want_n = SITES[name] * CFG["num_blocks"]
        _expect(n == want_n, f"{name}: {n} launches of #1 in one forward, "
                             f"expected {want_n}")
        _expect(est.shape == (2, wav.shape[-1]) and np.isfinite(est).all(),
                f"{name}: bad output {est.shape}")
        row = dict(launches=n, sites=SITES[name])
        if name == FLAGSHIP:
            # against float64 at GRAD_BLOCKS of the 16 blocks (the same
            # .pth): the 16-block CPU step took 22 s of the time limit
            del model
            model = BaseModel.from_pretrain(
                path, num_blocks=GRAD_BLOCKS).cuda()
            est, _, n4 = sites.check_then_run(
                lambda: separate(model, wav), f"{name} {GRAD_BLOCKS} blocks")
            _expect(n4 == SITES[name] * GRAD_BLOCKS,
                    f"{name} at {GRAD_BLOCKS} blocks: {n4} launches")
            db, cpu_s = cpu64_snr(model, wav, est)
            row.update(vs_cpu64_db=db, cpu64_s=cpu_s,
                       cpu64_blocks=GRAD_BLOCKS)
            against, limit = (f"card fp32 vs CPU float64 at {GRAD_BLOCKS} "
                              f"blocks {db:.2f} dB (the CPU {cpu_s:.1f} s)"
                              ), LIMIT_DB
        else:
            # the other 21 against the card's plain path at 2 blocks (a
            # cut for chip_smoke.py's time; their float64 parity against
            # the JAX package stays in the CPU tests)
            del model
            model = BaseModel.from_pretrain(
                path, num_blocks=CHECK_BLOCKS).cuda()
            est, plain, n2 = sites.check_then_run(
                lambda: separate(model, wav), f"{name} {CHECK_BLOCKS} blocks")
            _expect(n2 == SITES[name] * CHECK_BLOCKS,
                    f"{name} at {CHECK_BLOCKS} blocks: {n2} launches")
            row["check_blocks"], row["check_launches"] = CHECK_BLOCKS, n2
            db = row["vs_plain_on_card_db"] = snr_db(
                torch.from_numpy(plain), torch.from_numpy(est))
            against, limit = (f"card fp32 vs the card's plain path at "
                              f"{CHECK_BLOCKS} blocks {db:.2f} dB"), \
                PLAIN_LIMIT_DB
        print(f"{name}: {row['launches']} #1 launches a 16-block forward "
              f"({SITES[name]} x 16); {against} (limit {limit:.0f}); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        _expect(db >= limit, f"{name} disagrees: {db:.2f} dB")
        rec[name] = row
        del model
        torch.cuda.empty_cache()
    print(f"phase 24: #1 launched {sites.launches} times on the main path "
          f"(checks excluded), at {len(sites.checked)} site shapes, each "
          f"held against plain first")
    rec["flagship_times"] = time_flagship(card, sites)
    return rec, sites.launches


def time_flagship(card, sites):
    """TDANetEMCADv1_6 B=1 2 s fp32: the forward eager and replayed from a
    CUDA graph; a profiled window of replays: #1's device kernels
    (asserted), its share of the device time, the top device kernels."""
    model = models.get(FLAGSHIP)(**CFG)
    model.reset_parameters(torch.Generator().manual_seed(1234))
    model = model.cuda().eval()
    x = torch.from_numpy(tone_mix(SECONDS, seed=9)).cuda()[None]
    x = torch.nn.functional.pad(x, (0, PADDED - x.shape[-1]))
    with torch.inference_mode(), plain_sites(site_key) as keys:
        model(x)
    new = keys - sites.checked
    if new:
        check_forward(new, f"{FLAGSHIP} timed")
        sites.checked |= new
    with torch.inference_mode():
        ems, eruns, _ = cuda_time(lambda: model(x), reps=1, runs=9, warmup=2)
        gms, gruns, _ = graph_time(lambda: model(x), reps=1, runs=9)
    want = PROFILED_REPLAYS * SITES[FLAGSHIP] * CFG["num_blocks"]
    dw, dw_ms, dev_ms, kernels, top = profile_graph(model, x,
                                                    PROFILED_REPLAYS,
                                                    want=want)
    share = dw_ms / dev_ms if dev_ms > 0 else float("nan")
    print(f"{FLAGSHIP} forward B=1 {SECONDS} s fp32 (padded to {PADDED}): "
          f"eager median {ems:.2f} ms (runs {[round(t, 2) for t in eruns]}),"
          f" CUDA graph replay median {gms:.2f} ms (runs "
          f"{[round(t, 2) for t in gruns]}), {SECONDS / (gms / 1e3):.1f}x "
          f"realtime [{card}]")
    print(f"  {PROFILED_REPLAYS} replays profiled: {dw} dw_conv_glob_ln "
          f"device kernels (expected {want}), {dw_ms:.3f} of {dev_ms:.3f} "
          f"ms device time ({100 * share:.0f}%), {kernels} device kernels "
          f"[{card}]")
    for ms, count, key in top:
        print(f"    {ms:8.3f} ms {count:5d}x {key}")
    _expect(dw == want, f"{dw} #1 device kernels in the window, expected "
                        f"{want}")
    del model
    torch.cuda.empty_cache()
    return dict(forward_eager_ms=ems, forward_eager_runs=eruns,
                forward_graph_ms=gms, forward_graph_runs=gruns,
                profiled_replays=PROFILED_REPLAYS, profiled_dw_kernels=dw,
                replay_dw_ms=dw_ms / PROFILED_REPLAYS,
                replay_device_ms=dev_ms / PROFILED_REPLAYS,
                replay_dw_share=share, replay_kernels=kernels
                // PROFILED_REPLAYS,
                top=[(ms / PROFILED_REPLAYS, count // PROFILED_REPLAYS, key)
                     for ms, count, key in top], card=card)


def write_conf(tmp):
    """configs/tdanet.yml with its model swapped for TDANetEMCADv1_6 and
    feat_len for the recipe's 3 s segments, written to ``tmp``."""
    conf = load_yaml(TRAIN_CONF)
    net = conf["audionet"]
    net["audionet_name"] = FLAGSHIP
    data = conf["datamodule"]["data_config"]
    net["audionet_config"]["feat_len"] = feat_len_for(
        int(data["segment"] * data["sample_rate"]),
        net["audionet_config"]["enc_kernel_size"], data["sample_rate"])
    path = os.path.join(tmp, "tdanet_emcad_v1_6.yml")
    save_yaml(path, conf)
    return path, net["audionet_config"]["feat_len"]


def train_flagship(tmp, tr, cv):
    """audio_train on the recipe with TDANetEMCADv1_6: 2 epochs and a
    resume (``train_step.train_and_resume``), #1's launches exact over the
    run. Returns (record, #1's (forward, backward) launches of the run,
    feat_len)."""
    conf, feat_len = write_conf(tmp)
    trainer, resumed, run = train_step.train_and_resume(
        conf, tr, cv, os.path.join(tmp, "exp_emcad"))
    model = trainer.state.model
    _expect(type(model).__name__ == FLAGSHIP and model.sm.remat
            and model.feat_len == feat_len,
            f"trained {type(model).__name__}, remat {model.sm.remat}, "
            f"feat_len {model.feat_len}")
    sites = SITES[FLAGSHIP] * model.num_blocks
    steps = 2 * len(trainer.datamodule.train_dataloader())
    vals = 2 * len(trainer.datamodule.val_dataloader())
    # a step: the forward, again under recomputation, and one backward a
    # site (every site reaches the loss); a validation batch: one forward.
    # The trainer's remat "scales" checkpoints the era block whole (its JAX
    # class tags no landmark), so the count is full checkpointing's
    fwd, bwd = train_step.expected_launches(model.sm.remat, sites, 0,
                                            model.sm.landmarked)
    _expect(not model.sm.landmarked and fwd == 2 * sites,
            "the era block should be checkpointed whole")
    want = (fwd * steps + sites * vals, bwd * steps)
    print(f"{steps} steps and {vals} validation batches: #1 launches "
          f"{run} (expected {want})")
    _expect(run == want, f"#1 launches {run} over the run, expected {want}")
    return dict(history=trainer.history, resumed=resumed.history,
                run_launches=list(run)), run, feat_len


def drive_family_training(card, tmp, data=None):
    """Phase 25; ``data`` is (train dir, valid dir) of phase 16, else
    written here. Returns the record and #1's (forward, backward)
    launches of the audio_train run."""
    if data is None:
        data = (os.path.join(tmp, "tr"), os.path.join(tmp, "cv"))
        train_step.write_split(data[0], TRAIN_UTTERANCES, seed=0)
        train_step.write_split(data[1], VALID_UTTERANCES, seed=1)
    rec = {}
    with card_sites(site_key) as seen:
        model = models.get(FLAGSHIP)(**dict(train_step.RECIPE,
                                            num_blocks=GRAD_BLOCKS))
        model.reset_parameters(torch.Generator().manual_seed(79))
        low, launches, flips = train_step.check_gradients(
            model, SITES[FLAGSHIP] * model.num_blocks, seed=6,
            limit_db=GRAD_LIMIT_DB)
        rec["grad_min_snr_db"], rec["grad_kink_flips"] = low, flips
        rec["grad_step_launches"] = {str(k): list(v)
                                     for k, v in launches.items()}
        model.sm.remat = False
        _, sites = capture_step(
            model, PITLossWrapper(pairwise_neg_snr, threshold_byloss=True),
            *train_step.tone_batch(2, seconds=1.0, seed=6))
        rec["step_operands"] = {
            str(k): v for k, v in check_step_operands(
                sites, f"{FLAGSHIP} step B=2 1 s fp32").items()}
        del model, sites
        torch.cuda.empty_cache()
        train, run, feat_len = train_flagship(tmp, *data)
        rec.update(train)
        # the median of 3 steps after 1 (5 after 2 in phase 17): the
        # time limit
        step = train_step.time_steps(8, "scales", steps=3, warmup=1,
                                     model=FLAGSHIP, feat_len=feat_len)
        sites = SITES[FLAGSHIP] * train_step.RECIPE["num_blocks"]
        _expect(tuple(step["launches_per_step"]) == (2 * sites, sites),
                f"the step launched #1 {step['launches_per_step']} times, "
                f"expected {(2 * sites, sites)}")
        rec["step"] = dict(ms=step["ms"], runs=step["runs"],
                           peak_gib=step["peak_bytes"] / 2 ** 30,
                           launches=list(step["launches_per_step"]),
                           card=card)
    check_training_sites(seen, set(), "phase 25")
    rec["site_shapes"] = len(seen)
    return rec, run


def precision_study(seed=79, data_seed=6, operands_only=False):
    """TDANetEMCADv1_6 at the recipe's widths, B=2 1 s fp32, phase 25's
    weights and data: #1 at every site's own operands
    (:func:`check_step_operands`; alone with ``operands_only``), and every
    parameter's gradient by three fp32 paths (the card through #1, the
    card with #1's plain version, the CPU) against CPU float64, plain and
    at each path's own side of every activation kink
    (``train_step.Kinks``); and float64 against itself with its input
    perturbed by one fp32 rounding (2^-24 n). Returns the record."""
    loss_fn = PITLossWrapper(pairwise_neg_snr, threshold_byloss=True)
    model = models.get(FLAGSHIP)(**train_step.RECIPE)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    cpu32, cpu64 = copy.deepcopy(model), copy.deepcopy(model).double()
    model = model.cuda()
    model.sm.remat = False
    mix, src = train_step.tone_batch(2, seconds=1.0, seed=data_seed)
    grads, kinks = {}, {p: train_step.Kinks()
                        for p in ("kernel", "plain", "cpu fp32")}
    with kinks["kernel"]():
        grads["kernel"], sites = capture_step(model, loss_fn, mix, src)
    table = check_step_operands(sites, f"{FLAGSHIP} step B=2 1 s fp32")
    del sites
    if operands_only:
        return dict(sites={str(k): v for k, v in table.items()})
    with plain_sites(site_key), kinks["plain"]():
        _, grads["plain"] = train_step.loss_and_grads(model, loss_fn, mix,
                                                      src)
    t0 = time.perf_counter()
    mix64, src64 = mix.cpu().double(), src.cpu().double()
    _, g64 = train_step.loss_and_grads(cpu64, loss_fn, mix64, src64)
    with kinks["cpu fp32"]():
        _, grads["cpu fp32"] = train_step.loss_and_grads(
            cpu32, loss_fn, mix.cpu(), src.cpu())
    refs, flips = {}, {}
    for path, rec in kinks.items():
        replay = train_step.Kinks(rec.masks)
        with replay():
            _, refs[path] = train_step.loss_and_grads(cpu64, loss_fn, mix64,
                                                      src64)
        flips[path] = replay.flips
    noise = torch.randn(mix.shape, generator=torch.Generator().manual_seed(0),
                        dtype=torch.float64)
    _, moved = train_step.loss_and_grads(
        cpu64, loss_fn, mix64 * (1 + 2.0 ** -24 * noise), src64)
    print(f"the CPU's six steps: {time.perf_counter() - t0:.1f} s")
    top = max(g.abs().max().item() for g in g64.values())
    names = [n for n, g in g64.items() if g.abs().max().item() > 1e-9 * top]
    snr = {}
    for path, g in grads.items():
        snr[path] = {n: snr_db(g64[n], g[n].cpu()) for n in names}
        snr[f"{path}, kinks matched"] = {n: snr_db(refs[path][n],
                                                   g[n].cpu())
                                         for n in names}
    snr["float64, input x(1+2^-24 n)"] = {n: snr_db(g64[n], moved[n])
                                          for n in names}
    for path, v in snr.items():
        low = sorted(v.values())
        print(f"{path}: median {statistics.median(low):.2f} dB, lowest "
              f"{low[0]:.2f}, {sum(x < GRAD_LIMIT_DB for x in low)} of "
              f"{len(low)} below {GRAD_LIMIT_DB:g}")
    print("elements on the other side of a kink than in float64: " + ", ".join(
        f"{p} {n} of {sum(m.numel() for ms in kinks[p].masks for m in ms)}"
        for p, n in flips.items()))
    print("the 12 lowest by the kernel path (" + " / ".join(snr) + ", dB):")
    for n in sorted(names, key=snr["kernel"].get)[:12]:
        print("  " + " / ".join(f"{snr[p][n]:.2f}" for p in snr) + f"  {n}")
    return dict(sites={str(k): v for k, v in table.items()}, grads=snr,
                kink_flips=flips)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--precision", action="store_true",
                    help="only phase 25's gradient precision study")
    ap.add_argument("--operands", action="store_true",
                    help="only phase 25's check of #1 at the step's own "
                         "operands")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this probe runs on a GPU")
    card = card_line()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc each, at once
        list(pool.map(_build.build, ("dw_conv_glob_ln",
                                     "dw_conv_glob_ln_backward")))
    print(f"built #1 and its backward in {time.perf_counter() - t0:.1f} s")
    if args.precision or args.operands:
        record = dict(card=card, precision=precision_study(
            operands_only=args.operands))
    else:
        record = drive(card)
    print(json.dumps(record))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


def drive(card):
    """Phases 24 and 25 in a temp dir; the record."""
    with tempfile.TemporaryDirectory() as tmp:
        print("== 24 EMCAD-era family (launch counts from 0)")
        family, launches = drive_family(card, tmp)
        print(f"== 25 the EMCAD-era family's training (card: {card})")
        training, run = drive_family_training(card, tmp)
    return dict(card=card, family=family, era_launches=launches,
                training=training, era_train_launches=list(run))


if __name__ == "__main__":
    sys.exit(main() and 0)
