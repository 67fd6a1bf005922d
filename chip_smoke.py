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
     eager and replayed from one CUDA graph.
The last two lines are the kernels' JSON record and the result line.
"""

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CFG = dict(out_channels=128, in_channels=512, num_blocks=16,
           upsampling_depth=5, enc_kernel_size=4, num_sources=2,
           sample_rate=16000)
SITES_PER_BLOCK = 32  # 5 pyramid stages + 5 LA x 3 + 4 LA x 3
C = 512
SCALES = (2010, 1005, 503, 252, 126)  # the finest-to-coarsest chain, 2 s
VARIANTS = (  # (K, stride, bias): the four kinds of depthwise ConvNorm
    (5, 1, True), (5, 2, True), (5, 1, False), (1, 1, False))
REQUEST_SECONDS = (1.0, 2.0, 2.7)


def phase(name):
    print(f"== {name}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def site_inputs(B, T, K, bias, gen):
    """Main-path operands: the model's (B, C, T) activation seen as
    (B, T, C), and its depthwise ConvNorm parameters."""
    x = torch.randn(B, C, T, generator=gen).cuda().transpose(1, 2)
    w = (torch.randn(C, 1, K, generator=gen) * 0.2).cuda()
    b = (torch.randn(C, generator=gen) * 0.1).cuda() if bias else None
    g = torch.randn(C, generator=gen).cuda()
    be = torch.randn(C, generator=gen).cuda()
    return x, w, b, g, be


def snr_db(ref, est):
    ref = ref.double()
    err = est.double() - ref
    return 10 * math.log10(ref.square().sum().item()
                           / max(err.square().sum().item(), 1e-300))


def cuda_time(fn, reps, runs=7, warmup=3):
    """Median ms per call over ``runs`` runs of ``reps`` calls, the runs,
    and the runs more than twice the median."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    med = statistics.median(times)
    return med, times, [t for t in times if t > 2 * med]


def graph_time(fn, reps=50, runs=7):
    """Device ms per call, host cost excluded: ``reps`` calls captured in
    one CUDA graph, whose replay cuda_time times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    med, times, flagged = cuda_time(graph.replay, reps=1, runs=runs)
    return med / reps, [t / reps for t in times], [t / reps for t in flagged]


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

    from tdanet_tpu_torch.kernels import _build
    from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
        dw_conv_glob_ln, dw_conv_glob_ln_chunked, dw_conv_glob_ln_reference)
    from tdanet_tpu_torch.models import BaseModel, TDANetBest
    from tdanet_tpu_torch.utils import separate, separate_batched

    phase("2 build")
    so, seconds, report = _build.build("dw_conv_glob_ln")
    print(f"built {os.path.relpath(so)} in {seconds:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
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
    print(json.dumps({"kernels": [{
        "name": "dw_conv_glob_ln", "route": "cuda",
        "source": "tdanet_tpu_torch/csrc/dw_conv_glob_ln.cu",
        "replaces": "tdanet_tpu/kernels/fused_pyramid.py:72",
        "launches": main_path_launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": pms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
