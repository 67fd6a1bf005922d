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
The kernels are built at first use from tdanet_tpu_torch/csrc, all sources
at once in phase 2. The last two lines are the kernels' JSON record and
the result line.
"""

import copy
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tdanet_tpu_torch.kernels import _build
from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_chunked, dw_conv_glob_ln_reference)
from tdanet_tpu_torch.kernels.uconv_block import (
    fuse_expand_fused, fuse_expand_fused_reference, pyramid_fused,
    pyramid_fused_reference, scale_lengths, to_raw)
from tdanet_tpu_torch.models import BaseModel, TDANetBest
from tdanet_tpu_torch.probes import hybrid, uconv_kernel
from tdanet_tpu_torch.utils import separate, separate_batched
from tdanet_tpu_torch.utils.timing import (
    card_line, cuda_time, graph_time, snr_db)

CFG = dict(out_channels=128, in_channels=512, num_blocks=16,
           upsampling_depth=5, enc_kernel_size=4, num_sources=2,
           sample_rate=16000)
SITES_PER_BLOCK = 32  # 5 pyramid stages + 5 LA x 3 + 4 LA x 3
C = 512
SCALES = (2010, 1005, 503, 252, 126)  # the finest-to-coarsest chain, 2 s
VARIANTS = (  # (K, stride, bias): the four kinds of depthwise ConvNorm
    (5, 1, True), (5, 2, True), (5, 1, False), (1, 1, False))
REQUEST_SECONDS = (1.0, 2.0, 2.7)
SOURCES = ("dw_conv_glob_ln", "uconv_pyramid", "uconv_fuse_expand")
UCONV = dict(T=2010, Cout=128, depth=5)  # C as above: the bench's block
CHAIN = 20


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
            max_err = max(max_err, err)
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
    kernels = [{
        "name": "dw_conv_glob_ln", "route": "cuda",
        "source": "tdanet_tpu_torch/csrc/dw_conv_glob_ln.cu",
        "replaces": "tdanet_tpu/kernels/fused_pyramid.py:72",
        "launches": main_path_launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": pms}]

    gen = torch.Generator().manual_seed(5)
    phase("7 UConvBlock halves against plain (full width, every output)")
    half_err = check_halves(gen)
    phase("8 fused block path (launch counts from 0)")
    half_launches = drive_fused_path(gen)
    phase(f"9 times (CUDA events, median of 7 runs; card: {card})")
    half_times = time_halves(gen)
    for name, replaces in (("pyramid_fused", 521), ("fuse_expand_fused", 455)):
        src = "uconv_pyramid" if name == "pyramid_fused" else \
            "uconv_fuse_expand"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tdanet_tpu_torch/csrc/{src}.cu",
            "replaces": f"tdanet_tpu/kernels/uconv_block.py:{replaces}",
            "launches": half_launches[name], "max_abs_err": half_err[name],
            "ms": half_times[name][0], "plain_ms": half_times[name][1]})
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
