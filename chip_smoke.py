"""Drive the PyTorch port's main path once on a CUDA card, and check it.

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize(); any failure raises and the
exit code is not 0:
  1. device: require CUDA, print the card's name and power limit, turn
     TF32 off for convolutions and matrix products;
  2. build the CUDA kernels from tdanet_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version at every main-path site
     shape, fp32 and bf16;
  4. serve: a full-width TDANetBest (out 128, in 512, 16 blocks, depth 5,
     4 ms encoder, 2 sources, 16 kHz) with seeded random weights is saved
     in the reference checkpoint schema, loaded with from_pretrain, moved
     to the card, and answers three ``separate`` requests and one
     ``separate_batched`` call; the kernel's launch count must rise by
     32 x 16 per forward;
  5. agreement of the card's fp32 output with the same model in float64
     on the CPU through the plain path;
  6. times from CUDA events: kernel against plain, and the forward,
     eager and replayed from one CUDA graph;
  7. the two UConvBlock-half kernels (pyramid_fused, fuse_expand_fused)
     against their plain versions at full width (T 2010, C_out 128, C 512,
     depth 5), B 1 and 4: every output, pad rows included, fp32 with TF32
     off and bf16;
  8. the fused block path (pyramid_fused -> GA -> fuse_expand_fused),
     with its launch counts set to 0 just before: one block against
     UConvBlock.forward at B 1 and 4 (fp32), and 20 chained blocks against
     20 module blocks at B 24 in bf16 and B 1 in fp32; each wrapper's
     count must rise by exactly 1 per block;
  9. times: each half-block kernel against its plain version (B 1 and 4,
     fp32), and ms/block of the module, hybrid and fused blocks (B 1 fp32,
     B 24 bf16), eager and replayed from a CUDA graph.
  10. the window kernels (roll_and_window_partition, window_merge_and_roll)
     against their plain versions at the seven site shapes of Swin-UNet
     tiny, B 1, 2 (the Swin path's batch) and 8, fp32, bf16 and fp64:
     bit-exact, with the round trip and the gradients through each
     autograd Function;
  11. the Swin path, with its launch counts set to 0 just before: a
     full-width SwinTransformerSys (img 224, patch 4, embed 96, depths
     (2, 2, 2, 2), heads (3, 6, 12, 24), window 7) with seeded weights,
     B 2 fp32, three forwards and two forward-and-backward steps of a
     mean-of-squares loss; each window kernel must launch exactly 14 times
     per forward and 28 per forward + backward; output and two gradients
     against the same model in float64 on the CPU; one SwinTransformer
     classifier forward (12 launches each);
  12. every micro-kernel of the two op probes against its plain version at
     (24, 2032, 512) bf16, the products' SNR printed, and the count of
     wgmma (HGMMA) instructions in the built library, which must not be 0;
  13. times: the window kernels against plain, the Swin forward and
     forward + backward, and, with their launch counts set to 0 just
     before, the two probes through their entry points.
The kernels are built at first use from tdanet_tpu_torch/csrc, all sources
at once in phase 2. The last two lines are the kernels' JSON record and
the result line.
"""

import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tdanet_tpu_torch.kernels import _build, micro_ops
from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_chunked, dw_conv_glob_ln_reference)
from tdanet_tpu_torch.kernels.uconv_block import (
    fuse_expand_fused, fuse_expand_fused_reference, pyramid_fused,
    pyramid_fused_reference, scale_lengths, to_raw)
from tdanet_tpu_torch.kernels.window_process import (
    roll_and_window_partition, roll_and_window_partition_reference,
    window_merge_and_roll, window_merge_and_roll_reference)
from tdanet_tpu_torch.models import (
    BaseModel, SwinTransformer, SwinTransformerSys, TDANetBest)
from tdanet_tpu_torch.probes import (
    hybrid, mosaic_ops, mosaic_ops2, uconv_kernel)
from tdanet_tpu_torch.utils import separate, separate_batched
from tdanet_tpu_torch.utils.timing import (
    bound_ms, card_line, cuda_time, graph_time, nbytes, snr_db)

CFG = dict(out_channels=128, in_channels=512, num_blocks=16,
           upsampling_depth=5, enc_kernel_size=4, num_sources=2,
           sample_rate=16000)
SITES_PER_BLOCK = 32  # 5 pyramid stages + 5 LA x 3 + 4 LA x 3
C = 512
SCALES = (2010, 1005, 503, 252, 126)  # the finest-to-coarsest chain, 2 s
VARIANTS = (  # (K, stride, bias): the four kinds of depthwise ConvNorm
    (5, 1, True), (5, 2, True), (5, 1, False), (1, 1, False))
REQUEST_SECONDS = (1.0, 2.0, 2.7)
SOURCES = ("dw_conv_glob_ln", "uconv_pyramid", "uconv_fuse_expand",
           "window_process", "micro_ops")
UCONV = dict(T=2010, Cout=128, depth=5)  # C as above: the bench's block
CHAIN = 20
# Swin-UNet tiny's window sites (H = W, C, shift), window 7: two blocks per
# resolution, the second shifted, except at 7 x 7 (one window, no shift)
WINDOW = 7
WINDOW_SITES = ((56, 96, 0), (56, 96, 3), (28, 192, 0), (28, 192, 3),
                (14, 384, 0), (14, 384, 3), (7, 768, 0))
SWIN_BLOCKS = 14      # SwinTransformerSys: 8 encoder + 6 decoder blocks
CLASSIFIER_BLOCKS = 12  # SwinTransformer, depths (2, 2, 6, 2)
SWIN_BATCH = 2


def phase(name):
    print(f"== {name}", flush=True)


def site_inputs(B, T, K, bias, gen):
    """Main-path operands: the model's (B, C, T) activation seen as
    (B, T, C), and its depthwise ConvNorm parameters."""
    x = torch.randn(B, C, T, generator=gen).cuda().transpose(1, 2)
    w = (torch.randn(C, 1, K, generator=gen) * 0.2).cuda()
    b = (torch.randn(C, generator=gen) * 0.1).cuda() if bias else None
    g = torch.randn(C, generator=gen).cuda()
    be = torch.randn(C, generator=gen).cuda()
    return x, w, b, g, be


def dev_us(event):
    """A profiler average's self device time in us."""
    return event.self_device_time_total


def tone_mix(seconds, seed, sr=16000):
    """Two tones plus noise, as __graft_entry__._tone_sources makes them."""
    rng = np.random.default_rng(seed)
    T = int(round(seconds * sr))
    t = np.arange(T) / sr
    srcs = [0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * t
                         + rng.uniform(0, 6))
            + 0.02 * rng.standard_normal(T) for _ in range(2)]
    return np.sum(srcs, axis=0).astype(np.float32)


def half_inputs(B, dtype, gen, seed):
    """A seeded full-width block on the card, its padded input, and the
    plain pyramid's outputs (fp32) with the post-GA global feature: the
    operands of both halves."""
    T, Cout, depth = UCONV["T"], UCONV["Cout"], UCONV["depth"]
    block = uconv_kernel.seeded_block(Cout, C, depth, seed).cuda()
    x_raw = to_raw(torch.randn(B, Cout, T, generator=gen).cuda().to(dtype))
    scales, pooled = pyramid_fused_reference(
        x_raw.float(), block, depth=depth, raw=True, raw_in=True, T0=T)
    Tg = scale_lengths(T, depth)[-1]
    g = block.globalatt(pooled[:, :Tg].transpose(1, 2)).transpose(1, 2)
    return block, x_raw, [s.to(dtype) for s in scales], g.to(dtype)


def check_halves(gen):
    """Both kernels against their plain versions on the same inputs, every
    output with its pad rows: fp32 max |d| <= 2e-3 max |ref|, bf16 (plain
    in fp32 on the same bf16 inputs) SNR >= 30 dB. Returns the largest
    fp32 max |d| of each kernel."""
    T, depth = UCONV["T"], UCONV["depth"]
    Ts = scale_lengths(T, depth)
    worst = {"pyramid_fused": 0.0, "fuse_expand_fused": 0.0}
    with torch.inference_mode():
        for B in (1, 4):
            for dtype in (torch.float32, torch.bfloat16):
                block, x_raw, scales, g = half_inputs(B, dtype, gen, seed=B)
                got_s, got_g = pyramid_fused(x_raw, block, depth=depth,
                                             raw=True, raw_in=True, T0=T)
                ref_s, ref_g = pyramid_fused_reference(
                    x_raw.float(), block, depth=depth, raw=True,
                    raw_in=True, T0=T)
                got = fuse_expand_fused(scales, g, x_raw, block, Ts=Ts)
                ref = fuse_expand_fused_reference(
                    [s.float() for s in scales], g.float(), x_raw.float(),
                    block, Ts=Ts)
                pairs = {"pyramid_fused": list(zip(got_s + [got_g],
                                                   ref_s + [ref_g])),
                         "fuse_expand_fused": [(got, ref)]}
                for name, outs in pairs.items():
                    for i, (a, b) in enumerate(outs):
                        if a.shape != b.shape or a.dtype != dtype:
                            raise AssertionError(f"{name} output {i}: "
                                                 f"{a.shape} {a.dtype}")
                        if dtype == torch.float32:
                            err = (a - b).abs().max().item()
                            lim = 2e-3 * b.abs().max().item()
                            ok, what = err <= lim, \
                                f"max|d|={err:.3e} (limit {lim:.3e})"
                            worst[name] = max(worst[name], err)
                        else:
                            snr = snr_db(b, a)
                            ok, what = snr >= 30.0, \
                                f"SNR={snr:.1f} dB (limit 30)"
                        print(f"{name} B={B} {str(dtype)[6:]} output {i} "
                              f"{tuple(a.shape)}: {what}")
                        if not ok:
                            raise AssertionError(
                                f"{name} disagrees with its plain version")
    torch.cuda.synchronize()
    return worst


def count_blocks(fn, n):
    """Run fn, which makes n fused blocks; each wrapper must have launched
    exactly n times."""
    before = (pyramid_fused.launches, fuse_expand_fused.launches)
    out = fn()
    torch.cuda.synchronize()
    got = (pyramid_fused.launches - before[0],
           fuse_expand_fused.launches - before[1])
    if got != (n, n):
        raise AssertionError(f"{got} launches of (pyramid_fused, "
                             f"fuse_expand_fused) for {n} blocks")
    return out


def drive_fused_path(gen):
    """The fused block path against the module block; returns each
    wrapper's launches in this phase."""
    T, Cout, depth = UCONV["T"], UCONV["Cout"], UCONV["depth"]
    pyramid_fused.launches = fuse_expand_fused.launches = 0
    with torch.inference_mode():
        for B in (1, 4):
            block = uconv_kernel.seeded_block(Cout, C, depth, seed=10 + B)
            block = block.cuda()
            x = torch.randn(B, Cout, T, generator=gen).cuda()
            got = count_blocks(lambda: uconv_kernel.fused_block(block, x), 1)
            want = block(x)
            snr = snr_db(want, got)
            print(f"one fused block B={B} fp32 vs UConvBlock.forward: "
                  f"SNR {snr:.2f} dB (limit 60), finite "
                  f"{bool(torch.isfinite(got).all())}")
            if not (snr >= 60.0 and torch.isfinite(got).all()):
                raise AssertionError("fused block disagrees with the module")
        for B, dtype in ((24, torch.bfloat16), (1, torch.float32)):
            block = uconv_kernel.seeded_block(Cout, C, depth, seed=0).cuda()
            x = torch.randn(B, Cout, T, generator=gen).cuda().to(dtype)
            snr, err = count_blocks(
                lambda: uconv_kernel.compare_chain(block, x, CHAIN), CHAIN)
            print(f"{CHAIN} chained fused blocks B={B} {str(dtype)[6:]} vs "
                  f"{CHAIN} module blocks: SNR {snr:.2f} dB (limit 40), max "
                  f"abs {err:.4e}")
            if not snr >= 40.0:
                raise AssertionError("fused chain disagrees with the module")
    torch.cuda.synchronize()
    launches = {"pyramid_fused": pyramid_fused.launches,
                "fuse_expand_fused": fuse_expand_fused.launches}
    print(f"launches in this phase: {launches}")
    return launches


def time_halves(gen):
    """Each kernel against its plain version (B 1 and 4, fp32), then the
    blocks' ms; returns each kernel's B=1 (kernel ms, plain ms), device
    time from CUDA-graph replay."""
    T, depth = UCONV["T"], UCONV["depth"]
    Ts = scale_lengths(T, depth)
    result = {}
    with torch.inference_mode():
        for B in (1, 4):
            block, x_raw, scales, g = half_inputs(B, torch.float32, gen,
                                                  seed=B)
            calls = {
                "pyramid_fused": (
                    lambda: pyramid_fused(x_raw, block, depth=depth, raw=True,
                                          raw_in=True, T0=T),
                    lambda: pyramid_fused_reference(
                        x_raw, block, depth=depth, raw=True, raw_in=True,
                        T0=T)),
                "fuse_expand_fused": (
                    lambda: fuse_expand_fused(scales, g, x_raw, block, Ts=Ts),
                    lambda: fuse_expand_fused_reference(scales, g, x_raw,
                                                        block, Ts=Ts))}
            for name, (kern, plain) in calls.items():
                kg, pg = graph_time(kern), graph_time(plain)
                ke, pe = cuda_time(kern, reps=20), cuda_time(plain, reps=20)
                flags = [f for t in (kg, pg, ke, pe) for f in t[2]]
                print(f"{name} B={B} fp32, us per call, device (graph replay)"
                      f" / eager: kernel {kg[0] * 1e3:.1f} / "
                      f"{ke[0] * 1e3:.1f}, plain {pg[0] * 1e3:.1f} / "
                      f"{pe[0] * 1e3:.1f}"
                      + (f"; runs over 2x median: {flags}" if flags else ""))
                if B == 1:
                    result[name] = (kg[0], pg[0])
        for B, dtype in ((1, torch.float32), (24, torch.bfloat16)):
            block, x = uconv_kernel.setup(B, dtype)
            rows = {**hybrid.time_blocks(block, x),
                    **uconv_kernel.time_blocks(block, x)}
            for name, (g_ms, e_ms) in rows.items():
                print(f"{name} B={B} {str(dtype)[6:]}: {g_ms:.3f} ms/block "
                      f"CUDA graph, {e_ms:.3f} ms/block eager")
        from torch.profiler import ProfilerActivity, profile
        x_raw = to_raw(x)
        uconv_kernel.fused_block_raw(block, x_raw, T)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            uconv_kernel.fused_block_raw(block, x_raw, T)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None)
                  == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(dev_us(e) for e in events) / 1e3
        print(f"profiled fused block B=24 bf16: "
              f"{sum(e.count for e in events)} device kernels, "
              f"{dev_ms:.3f} ms device time")
        for e in sorted(events, key=dev_us, reverse=True)[:10]:
            print(f"  {dev_us(e) / 1e3:8.3f} ms {e.count:4d}x {e.key[:90]}")
    torch.cuda.synchronize()
    return result


def params_bytes(*modules):
    return sum(nbytes(*m.parameters()) for m in modules)


def uconv_bounds(gen, B, dtype):
    """The card's bound for each UConvBlock half from this run's operands:
    every input and parameter read once, every output written once,
    against the operations of the 1x1 product (fp32 on the SIMT cores,
    bf16 on the tensor cores) and of the depthwise taps (fp32)."""
    T, Cout, depth = UCONV["T"], UCONV["Cout"], UCONV["depth"]
    Ts = scale_lengths(T, depth)
    block, x_raw, scales, g = half_inputs(B, dtype, gen, seed=1)
    with torch.inference_mode():
        got_s, got_g = pyramid_fused(x_raw, block, depth=depth, raw=True,
                                     raw_in=True, T0=T)
        out = fuse_expand_fused(scales, g, x_raw, block, Ts=Ts)
    product = 2.0 * B * T * Cout * C
    taps = sum(2.0 * 5 * B * t * C for t in Ts)
    la = sum(2.0 * 3 * B * t * C for t in Ts) + 3 * taps
    peak = "bf16" if dtype is torch.bfloat16 else "fp32"
    halves = {
        "pyramid_fused": (
            nbytes(x_raw, *got_s, got_g)
            + params_bytes(block.proj_1x1, block.spp_dw), taps),
        "fuse_expand_fused": (
            nbytes(x_raw, g, out, *scales)
            + params_bytes(block.loc_glo_fus, block.last_layer,
                           block.res_conv), la)}
    result = {}
    for name, (n_bytes, simt) in halves.items():
        by_bytes = bound_ms(n_bytes)[0]
        by_ops = bound_ms(0, product, peak)[0] + bound_ms(0, simt)[0]
        result[name] = max((by_ops, "operations"), (by_bytes, "bytes"))
        print(f"{name} B={B} {str(dtype)[6:]}: {n_bytes / 1e6:.2f} MB -> "
              f"{by_bytes * 1e3:.2f} us by bytes; {product / 1e9:.3f} GFLOP "
              f"of {peak} product and {simt / 1e9:.3f} GFLOP of taps -> "
              f"{by_ops * 1e3:.2f} us by operations; bound "
              f"{result[name][0] * 1e3:.2f} us ({result[name][1]})")
    return result


def check_windows(gen):
    """Both window kernels against their plain versions, bit for bit, at
    every site shape; the round trip; the gradients through each autograd
    Function. Returns the largest abs difference seen (0)."""
    worst = 0.0
    for B in (1, SWIN_BATCH, 8):  # SWIN_BATCH: the Swin path's own shapes
        for H, Cw, shift in WINDOW_SITES:
            for dtype in (torch.float32, torch.bfloat16, torch.float64):
                x = torch.randn(B, H, H, Cw, generator=gen).to(dtype).cuda()
                x.requires_grad_()
                wins = roll_and_window_partition(x, shift, WINDOW)
                ref = roll_and_window_partition_reference(x, shift, WINDOW)
                back = window_merge_and_roll(wins, shift, WINDOW, H, H)
                back_ref = window_merge_and_roll_reference(ref, shift,
                                                           WINDOW, H, H)
                gx, = torch.autograd.grad(wins.pow(3).sum(), x,
                                          retain_graph=True)
                gx_ref, = torch.autograd.grad(ref.pow(3).sum(), x)
                w = wins.detach().requires_grad_()
                gw, = torch.autograd.grad(window_merge_and_roll(
                    w, shift, WINDOW, H, H).pow(3).sum(), w)
                gw_ref, = torch.autograd.grad(
                    window_merge_and_roll_reference(
                        w, shift, WINDOW, H, H).pow(3).sum(), w)
                pairs = {"partition": (wins, ref), "merge": (back, back_ref),
                         "round trip": (back, x),
                         "partition gradient": (gx, gx_ref),
                         "merge gradient": (gw, gw_ref)}
                for what, (a, b) in pairs.items():
                    worst = max(worst, (a.double() - b.double()).abs().max()
                                .item())
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"window {what} differs at B={B} H={H} C={Cw} "
                            f"shift={shift} {dtype}")
        print(f"B={B}: {len(WINDOW_SITES)} sites x fp32, bf16, fp64: "
              f"partition, merge, round trip and both gradients bit-exact")
    # a channel count that no 16-byte vector divides, and a strided input
    x = torch.randn(2, 8, 12, 37, generator=gen).bfloat16().cuda()
    for v in (x, x.transpose(1, 2)):
        if not torch.equal(roll_and_window_partition(v, 3, 4),
                           roll_and_window_partition_reference(v, 3, 4)):
            raise AssertionError("window partition differs at C=37")
    print("C=37 bf16 (2-byte vectors), contiguous and transposed: bit-exact")
    torch.cuda.synchronize()
    return worst


def window_counts():
    return (roll_and_window_partition.launches,
            window_merge_and_roll.launches)


def expect_window_launches(fn, n, what):
    """Run fn; each window kernel must have launched exactly n times."""
    before = window_counts()
    out = fn()
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(window_counts(), before))
    if got != (n, n):
        raise AssertionError(f"{got} launches of (roll_and_window_partition, "
                             f"window_merge_and_roll) for {what}, expected "
                             f"{n} each")
    return out


def swin_step(model, x):
    """One forward-and-backward step of a mean-of-squares loss."""
    model.zero_grad(set_to_none=True)
    out = model(x)
    out.square().mean().backward()
    return out


def drive_swin(gen):
    """The Swin path on the card; returns the two kernels' launches on it,
    the model and its input."""
    model = SwinTransformerSys(drop_rate=0.0, attn_drop_rate=0.0,
                               drop_path_rate=0.0)
    model.reset_parameters(torch.Generator().manual_seed(4321))
    model = model.cuda()
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.randn(SWIN_BATCH, 3, 224 * 224, generator=gen).cuda()
    roll_and_window_partition.launches = window_merge_and_roll.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(3):
            out = expect_window_launches(lambda: model(x), SWIN_BLOCKS,
                                         "one forward")
    for _ in range(2):
        out_train = expect_window_launches(
            lambda: swin_step(model, x), 2 * SWIN_BLOCKS,
            "one forward + backward")
    launches = dict(zip(("roll_and_window_partition",
                         "window_merge_and_roll"), window_counts()))
    want_shape = (SWIN_BATCH, 1000, 224 * 224)
    for o in (out, out_train):
        if o.shape != want_shape or not torch.isfinite(o).all():
            raise AssertionError(f"bad Swin output {tuple(o.shape)}")
    print(f"SwinTransformerSys ({n_params / 1e6:.1f} M parameters), input "
          f"{tuple(x.shape)} -> {tuple(out.shape)}: 3 forwards and 2 forward"
          f" + backward steps in {time.perf_counter() - t0:.2f} s (first "
          f"calls included); launches {launches} ({SWIN_BLOCKS} each per "
          f"forward, {2 * SWIN_BLOCKS} per forward + backward)")

    cpu64 = copy.deepcopy(model).cpu().double()
    want = swin_step(cpu64, x.cpu().double())
    checks = [("output", want.detach(), out, 60.0)]
    for name in ("patch_embed.proj.weight",
                 "layers.0.blocks.1.attn.relative_position_bias_table"):
        checks.append((f"gradient of {name}",
                       cpu64.get_parameter(name).grad,
                       model.get_parameter(name).grad, 50.0))
    for what, ref, got, limit in checks:
        snr = snr_db(ref, got.cpu())
        print(f"{what}: card fp32 vs CPU float64 plain path SNR = "
              f"{snr:.2f} dB (limit {limit:.0f})")
        if not snr >= limit:
            raise AssertionError(f"Swin {what} disagrees with the CPU")

    clf = SwinTransformer(drop_path_rate=0.0)
    clf.reset_parameters(torch.Generator().manual_seed(99))
    clf = clf.cuda().eval()
    img = torch.randn(SWIN_BATCH, 3, 224, 224, generator=gen).cuda()
    with torch.no_grad():
        logits = expect_window_launches(lambda: clf(img), CLASSIFIER_BLOCKS,
                                        "one classifier forward")
    if logits.shape != (SWIN_BATCH, 1000) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad classifier output {tuple(logits.shape)}")
    print(f"SwinTransformer (depths (2, 2, 6, 2)) forward {tuple(img.shape)}"
          f" -> {tuple(logits.shape)}: {CLASSIFIER_BLOCKS} launches each")
    torch.cuda.synchronize()
    return launches, model, x


def time_windows_and_swin(gen, model, x):
    """The window kernels against plain (fp32, shift 3), the Swin forward
    (graph replay and eager) and forward + backward (eager). Returns each
    kernel's (kernel ms, plain ms, bound ms, bound by) at the main path's
    largest site, (SWIN_BATCH, 56, 56, 96)."""
    result = {}
    H, Cw, shift = 56, 96, 3
    with torch.inference_mode():
        for B in (1, SWIN_BATCH, 8):
            img = torch.randn(B, H, H, Cw, generator=gen).cuda()
            wins = roll_and_window_partition(img, shift, WINDOW)
            calls = {
                "roll_and_window_partition": (
                    lambda: roll_and_window_partition(img, shift, WINDOW),
                    lambda: roll_and_window_partition_reference(
                        img, shift, WINDOW)),
                "window_merge_and_roll": (
                    lambda: window_merge_and_roll(wins, shift, WINDOW, H, H),
                    lambda: window_merge_and_roll_reference(
                        wins, shift, WINDOW, H, H))}
            bms, by = bound_ms(nbytes(img, wins))
            for name, (kern, plain) in calls.items():
                kg, pg = graph_time(kern), graph_time(plain)
                ke, pe = cuda_time(kern, reps=50), cuda_time(plain, reps=50)
                print(f"{name} ({B}, {H}, {H}, {Cw}) fp32 shift {shift}, us "
                      f"per call, device (graph replay) / eager: kernel "
                      f"{kg[0] * 1e3:.2f} / {ke[0] * 1e3:.2f}, plain "
                      f"{pg[0] * 1e3:.2f} / {pe[0] * 1e3:.2f}; bound "
                      f"{bms * 1e3:.2f} ({by})")
                if B == SWIN_BATCH:
                    result[name] = (kg[0], pg[0], bms, by)
    model.eval()
    with torch.no_grad():
        gms, gruns, _ = graph_time(lambda: model(x), reps=2, runs=7)
        ems, eruns, _ = cuda_time(lambda: model(x), reps=1, runs=7, warmup=2)
    tms, truns, _ = cuda_time(lambda: swin_step(model, x), reps=1, runs=7,
                              warmup=2)
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(x)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(dev_us(e) for e in events) / 1e3
    win = [e for e in events if "window_kernel" in e.key]
    print(f"profiled Swin forward: {sum(e.count for e in events)} device "
          f"kernels, {dev_ms:.3f} ms device time; window kernels "
          f"{sum(e.count for e in win)} launches, "
          f"{sum(dev_us(e) for e in win) / 1e3:.3f} ms")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        print(f"  {dev_us(e) / 1e3:8.3f} ms {e.count:4d}x {e.key[:90]}")
    print(f"SwinTransformerSys forward B={SWIN_BATCH} fp32: CUDA graph "
          f"replay {gms:.2f} ms (runs {[round(t, 2) for t in gruns]}), "
          f"eager {ems:.2f} ms (runs {[round(t, 2) for t in eruns]}); "
          f"forward + backward eager {tms:.2f} ms "
          f"(runs {[round(t, 2) for t in truns]})")
    torch.cuda.synchronize()
    return result


def count_hgmma():
    """The wgmma (SASS: HGMMA) instructions in the built micro_ops library,
    where the toolkit's ``cuobjdump`` is there to list them: the bf16
    products must have reached the warpgroup instruction."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("no cuobjdump on this machine: HGMMA not counted")
        return
    so = _build.library_path("micro_ops")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    print(f"HGMMA instructions in {os.path.relpath(so)}: {n}")
    if n == 0:
        raise AssertionError("the bf16 products did not reach wgmma")


def drive_probes():
    """The two op probes through their entry points, with every
    micro-kernel's launch count set to 0 just before; returns their
    records. Every variant must have launched its kernel."""
    for w in micro_ops.WRAPPERS:
        w.launches = 0
    records = {"probe_mosaic_ops": mosaic_ops.main([]),
               "probe_mosaic_ops2": mosaic_ops2.main([])}
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in micro_ops.WRAPPERS}
    print(f"launches on the probes' path: {counts}")
    for rows in records.values():
        for row in rows:
            if row["launches"] < 1:
                raise AssertionError(f"{row['name']} never launched")
    if min(counts.values()) < 1:
        raise AssertionError(f"a micro-kernel never launched: {counts}")
    return records


def probe_entry(name, script, line, rows):
    """One kernels-line entry for a probe: sums over its variants;
    ``library_ms`` sums the variants that one PyTorch call computes."""
    library = [r["library_ms"] for r in rows if r["library_ms"] is not None]
    by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    total = sum(r["bound_ms"] for r in rows)
    return {
        "name": name, "route": "cuda",
        "source": "tdanet_tpu_torch/csrc/micro_ops.cu",
        "replaces": f"scripts/{script}.py:{line}",
        "launches": sum(r["launches"] for r in rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": total,
        "bound_by": "operations" if by_ops > total - by_ops else "bytes",
        "library_ms": sum(library) if library else None, "variants": rows}


def main():
    phase("1 device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: chip_smoke.py runs only on a GPU")
    card = card_line()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN convolutions and CUDA matmuls; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.cuda.synchronize()

    phase("2 build (one nvcc per source, all at once)")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(_build.build, SOURCES))
    print(f"built {len(SOURCES)} sources in "
          f"{time.perf_counter() - t0:.2f} s wall")
    for so, seconds, report in built:
        print(f"  {os.path.relpath(so)}: nvcc {seconds:.2f} s")
        for line in report.splitlines():
            if "Compiling entry function" in line:  # the kernel's name
                print("    ptxas:", line.split("'")[1][:100])
            elif "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())
    torch.cuda.synchronize()

    phase("3 kernel against plain (C=512, model layout)")
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    with torch.inference_mode():
        for B in (1, 4):
            for T in SCALES:
                for K, stride, bias in VARIANTS:
                    x, w, b, g, be = site_inputs(B, T, K, bias, gen)
                    got = dw_conv_glob_ln(x, w, b, g, be, stride=stride, K=K)
                    ref = dw_conv_glob_ln_reference(x, w, b, g, be,
                                                    stride=stride, K=K)
                    err = (got - ref).abs().max().item()
                    lim = 1e-4 * ref.abs().max().item()
                    x16 = x.bfloat16()
                    got16 = dw_conv_glob_ln(x16, w, b, g, be, stride=stride,
                                            K=K)
                    ref16 = dw_conv_glob_ln_reference(
                        x16.float(), w, b, g, be, stride=stride, K=K)
                    snr16 = snr_db(ref16, got16)
                    print(f"B={B} T={T:4d} K={K} s={stride} bias={bias!s:5}"
                          f" fp32 max|d|={err:.3e} (limit {lim:.3e})"
                          f" bf16 SNR={snr16:.1f} dB")
                    if not (err <= lim and snr16 >= 40.0):
                        raise AssertionError("kernel disagrees with plain")
                    max_err = max(max_err, err)
        chunked_err = 0.0
        for B in (1, 4):  # the chunked entry, channels-last (B, T, C)
            x, w, b, g, be = site_inputs(B, 2010, 5, True, gen)
            x = x.contiguous()
            got = dw_conv_glob_ln_chunked(x, w, b, g, be)
            ref = dw_conv_glob_ln_reference(x, w, b, g, be)
            err = (got - ref).abs().max().item()
            print(f"chunked B={B} T=2010 (B,T,C)-contiguous "
                  f"max|d|={err:.3e}")
            if not err <= 1e-4 * ref.abs().max().item():
                raise AssertionError("chunked kernel disagrees with plain")
            chunked_err = max(chunked_err, err)
    torch.cuda.synchronize()

    phase("4 serve (full width, 16 blocks)")
    model = TDANetBest(**CFG)
    model.reset_parameters(torch.Generator().manual_seed(1234))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "best_model.pth")
        torch.save(model.serialize(), path)
        model = BaseModel.from_pretrain(path).to("cuda")
    per_forward = SITES_PER_BLOCK * CFG["num_blocks"]
    mixes = [tone_mix(s, seed=i) for i, s in enumerate(REQUEST_SECONDS)]
    dw_conv_glob_ln.launches = 0
    t0 = time.perf_counter()
    outs = []
    for mix in mixes:
        before = dw_conv_glob_ln.launches
        est = separate(model, mix)
        if dw_conv_glob_ln.launches - before != per_forward:
            raise AssertionError(
                f"{dw_conv_glob_ln.launches - before} kernel launches for "
                f"one forward, expected {per_forward}")
        if est.shape != (2, mix.shape[-1]) or not np.isfinite(est).all():
            raise AssertionError(f"bad output {est.shape}")
        outs.append(est)
    before = dw_conv_glob_ln.launches
    batched = separate_batched(model, mixes)
    n_buckets = len({-(-m.shape[-1] // model.lcm) for m in mixes})
    if dw_conv_glob_ln.launches - before != per_forward * n_buckets:
        raise AssertionError("separate_batched missed the kernel")
    for mix, est, one in zip(mixes, batched, outs):
        if est.shape != (2, mix.shape[-1]) or not np.isfinite(est).all():
            raise AssertionError(f"bad batched output {est.shape}")
        if np.abs(est - one).max() > 1e-3 * np.abs(one).max():
            raise AssertionError("separate_batched differs from separate")
    torch.cuda.synchronize()
    main_path_launches = dw_conv_glob_ln.launches
    print(f"answered {len(mixes)} separate requests of {REQUEST_SECONDS} s "
          f"and one separate_batched call ({n_buckets} buckets) in "
          f"{time.perf_counter() - t0:.2f} s (first calls included); "
          f"dw_conv_glob_ln launches: {main_path_launches} "
          f"({per_forward} per forward)")

    phase("5 agreement with float64 on the CPU")
    cpu64 = copy.deepcopy(model).cpu().double()
    want = separate(cpu64, mixes[0])
    agree = snr_db(torch.from_numpy(want), torch.from_numpy(outs[0]))
    print(f"1.0 s request: card fp32 vs CPU float64 plain path "
          f"SNR = {agree:.2f} dB (limit 60)")
    if not agree >= 60.0:
        raise AssertionError("card output disagrees with the CPU reference")
    torch.cuda.synchronize()

    phase(f"6 times (CUDA events, median of 7 runs; card: {card})")
    timings = {}
    with torch.inference_mode():
        for B in (1, 4):
            for K, stride, bias in VARIANTS:
                x, w, b, g, be = site_inputs(B, 2010, K, bias, gen)
                args = (x, w, b, g, be)
                kw = dict(stride=stride, K=K)
                row = {}
                for name, fn in (("kernel", dw_conv_glob_ln),
                                 ("plain", dw_conv_glob_ln_reference)):
                    call = (lambda fn=fn: fn(*args, **kw))
                    row[name] = (graph_time(call),
                                 cuda_time(call, reps=50))
                timings[(B, K, stride, bias)] = (row["kernel"][0][0],
                                                 row["plain"][0][0])
                flags = [f for r in row.values() for t in r for f in t[2]]
                print(f"dw_conv_glob_ln B={B} T=2010 C={C} K={K} s={stride} "
                      f"bias={bias!s:5} fp32, us per call, device (graph "
                      f"replay) / eager: kernel "
                      f"{row['kernel'][0][0] * 1e3:.1f} / "
                      f"{row['kernel'][1][0] * 1e3:.1f}, plain "
                      f"{row['plain'][0][0] * 1e3:.1f} / "
                      f"{row['plain'][1][0] * 1e3:.1f}"
                      + (f"; runs over 2x median: {flags}" if flags else ""))
        # 32000 samples: the finest scale is the (1, 512, 2010) timed above
        wav = torch.from_numpy(tone_mix(2.0, seed=9)).cuda()[None]
        fms, fruns, fflag = cuda_time(lambda: model(wav), reps=1, runs=9,
                                      warmup=2)
        print(f"forward B=1, 2.0 s clip: median {fms:.2f} ms "
              f"(runs {[round(t, 2) for t in fruns]}), "
              f"{2.0 / (fms / 1e3):.1f}x realtime"
              + (f"; runs over 2x median: {fflag}" if fflag else ""))
        # the same forward replayed from one CUDA graph: its device time
        # without the host's per-launch cost
        gms, gruns, gflag = graph_time(lambda: model(wav), reps=1, runs=9)
        print(f"forward B=1, 2.0 s clip, CUDA graph replay: median "
              f"{gms:.2f} ms (runs {[round(t, 2) for t in gruns]}), "
              f"{2.0 / (gms / 1e3):.1f}x realtime"
              + (f"; runs over 2x median: {gflag}" if gflag else ""))
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(wav)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None)
                  == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(dev_us(e) for e in events) / 1e3
        n_kernels = sum(e.count for e in events)
        if dev_ms > 0:
            print(f"profiled forward: {n_kernels} device kernels, "
                  f"{dev_ms:.2f} ms device time in {wall:.2f} ms wall "
                  f"(device busy {100 * dev_ms / wall:.0f}%, profiler on)")
            for e in sorted(events, key=dev_us, reverse=True)[:8]:
                print(f"  {dev_us(e) / 1e3:8.2f} ms "
                      f"{e.count:5d}x {e.key[:90]}")
        else:
            print("profiled forward: device time not measured "
                  "(the profiler recorded no CUDA kernels)")
    torch.cuda.synchronize()

    ms, pms = timings[(1, 5, 1, True)]
    x, w, b, g, be = site_inputs(1, 2010, 5, True, gen)
    bms, by = bound_ms(2 * nbytes(x) + nbytes(w, b, g, be),
                       (2.0 * 5 + 6) * x.numel())
    # no single PyTorch call computes any of kernels #1-#6 (conv + norm,
    # roll + permuting copy are two calls each, the plain versions). One
    # entry for the one kernel behind both depthwise wrappers: the served
    # path calls dw_conv_glob_ln, so the launches, error and times are that
    # wrapper's; dw_conv_glob_ln_chunked, its stride-1 form, has its own
    # check above and its error beside.
    kernels = [{
        "name": "dw_conv_glob_ln", "route": "cuda",
        "source": "tdanet_tpu_torch/csrc/dw_conv_glob_ln.cu",
        "replaces": "tdanet_tpu/kernels/fused_pyramid.py:72",
        "also_replaces": "tdanet_tpu/kernels/fused_pyramid_chunked.py:106",
        "launches": main_path_launches, "max_abs_err": max_err,
        "chunked_max_abs_err": chunked_err,
        "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
        "library_ms": None}]

    gen = torch.Generator().manual_seed(5)
    phase("7 UConvBlock halves against plain (full width, every output)")
    half_err = check_halves(gen)
    phase("8 fused block path (launch counts from 0)")
    half_launches = drive_fused_path(gen)
    phase(f"9 times (CUDA events, median of 7 runs; card: {card})")
    half_times = time_halves(gen)
    half_bounds = uconv_bounds(gen, 1, torch.float32)
    uconv_bounds(gen, 24, torch.bfloat16)
    for name, replaces in (("pyramid_fused", 521), ("fuse_expand_fused", 455)):
        src = "uconv_pyramid" if name == "pyramid_fused" else \
            "uconv_fuse_expand"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tdanet_tpu_torch/csrc/{src}.cu",
            "replaces": f"tdanet_tpu/kernels/uconv_block.py:{replaces}",
            "launches": half_launches[name], "max_abs_err": half_err[name],
            "ms": half_times[name][0], "plain_ms": half_times[name][1],
            "bound_ms": half_bounds[name][0],
            "bound_by": half_bounds[name][1], "library_ms": None})
    torch.cuda.synchronize()

    gen = torch.Generator().manual_seed(10)
    phase("10 window kernels against plain (bit-exact)")
    window_err = check_windows(gen)
    phase("11 Swin path (launch counts from 0)")
    window_launches, swin, swin_x = drive_swin(gen)
    phase("12 micro-kernels against plain ((24, 2032, 512) bf16)")
    with torch.inference_mode():
        operands = mosaic_ops.inputs()
        for probe in (mosaic_ops, mosaic_ops2):
            for v in probe.variants(*operands):
                mosaic_ops.check(v)
        del operands
    count_hgmma()
    torch.cuda.synchronize()
    phase(f"13 times (CUDA events, median of 7 runs; card: {card})")
    window_times = time_windows_and_swin(gen, swin, swin_x)
    del swin, swin_x
    probe_records = drive_probes()
    for name, line in (("roll_and_window_partition", 103),
                       ("window_merge_and_roll", 133)):
        kms, pms, bms, by = window_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tdanet_tpu_torch/csrc/window_process.cu",
            "replaces": f"tdanet_tpu/kernels/window_process.py:{line}",
            "launches": window_launches[name], "max_abs_err": window_err,
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None})
    kernels.append(probe_entry("probe_mosaic_ops", "probe_mosaic_ops", 42,
                               probe_records["probe_mosaic_ops"]))
    kernels.append(probe_entry("probe_mosaic_ops2", "probe_mosaic_ops2", 38,
                               probe_records["probe_mosaic_ops2"]))
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
