"""Profiled windows of TDANetYang's CUDA-graph replays, with and without
idle host time at the window's ends, of 1 and of 3 replays, and with and
without a spin kernel on the device before and after the replays: how
many device kernels each window keeps (ROADMAP C #8). Since
``timing.profiled`` frames every window's work with sentinel spin
kernels and leaves them out of its results, the spin kernels this probe
adds are left out too.

    python -m tdanet_tpu_torch.probes.profiler_windows [--windows 10]
        [--out record.json]

Phase 22's profiled forward: TDANetYang at ``configs/tdanet_origin.yml``'s
widths (out 128, in 512, 16 blocks, depth 5) at 16 kHz, seeded random
weights, B=1 2 s, captured in one CUDA graph. Windows of each kind
alternate. A window can only lose kernels, so the most that any window
of a kind counted is what its replays launch; a window below it lost
events. For each short window the kernels it lacks are printed by name,
with the window's first device start, last device end and last host end
(us from the window's first host event), and how many device kernels
precede its first #1 kernel (a loss at the start of the device work
shortens that)."""

from __future__ import annotations

import argparse
import collections
import json

import torch

from tdanet_tpu_torch import models
from tdanet_tpu_torch.probes.train_step import tone_mix
from tdanet_tpu_torch.probes.variants import CFG, PROFILED_REPLAYS
from tdanet_tpu_torch.utils.timing import WINDOW_PAD_S, card_line, profiled


def capture(seed=100):
    """TDANetYang's forward on a 2 s clip, captured in one CUDA graph."""
    model = models.get("TDANetYang")(**CFG)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.cuda().eval()
    x = torch.from_numpy(tone_mix(2.0, seed=0)).cuda()[None]
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                model(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            model(x)
        graph.replay()
        torch.cuda.synchronize()
    return model, graph


def window(graph, pad_s, replays=PROFILED_REPLAYS, spin=False):
    """One window of ``replays`` replays, after and before a spin kernel
    on the device with ``spin``: (device kernels by name, (first device
    start, last device end, last host end) in us from the window's first
    host event, the device kernels before the first #1 kernel)."""
    with torch.inference_mode(), profiled(pad_s) as prof:
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(replays):
            graph.replay()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted((e for e in events if e.device_type == cuda),
                 key=lambda e: e.time_range.start)
    host = [e for e in events if e.device_type != cuda]
    host0 = min((e.time_range.start for e in host), default=0.0)
    host1 = max((e.time_range.end for e in host), default=0.0)
    names = collections.Counter(e.name for e in dev)
    span = (min(e.time_range.start for e in dev) - host0,
            max(e.time_range.end for e in dev) - host0,
            host1 - host0) if dev else (0, 0, 0)
    lead = next((i for i, e in enumerate(dev) if DW in e.name), len(dev))
    return names, span, lead


DW = "dw_conv_glob_ln"
SPIN_CYCLES = 2_000_000  # about 1 ms at the card's clock
KINDS = [(pad, replays, spin) for replays in (1, PROFILED_REPLAYS)
         for spin in (False, True) for pad in (0.0, WINDOW_PAD_S)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=10,
                    help="windows of each kind")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this probe runs on a GPU")
    card = card_line()
    print(card, flush=True)
    _, graph = capture()
    reads = []
    for i in range(args.windows):
        for kind in KINDS:
            reads.append((kind, *window(graph, *kind)))
    record = {"card": card, "kinds": {}}
    for kind in KINDS:
        rows = [(names, span, lead) for k, names, span, lead in reads
                if k == kind]
        full = collections.Counter()
        for names, _, _ in rows:
            full = full | names
        want = sum(full.values())
        want_dw = sum(n for k, n in full.items() if DW in k)
        short = [(names, span, lead) for names, span, lead in rows
                 if sum(names.values()) < want]
        dw = [sum(n for k, n in names.items() if DW in k)
              for names, _, _ in rows]
        pad, replays, spin = kind
        record["kinds"][f"pad {pad} replays {replays} spin {spin}"] = dict(
            windows=len(rows), most_kernels=want, most_dw=want_dw,
            short_windows=len(short),
            short_dw_windows=sum(d < want_dw for d in dw),
            lost_kernels=[want - sum(n.values()) for n, _, _ in short],
            dw_counts=dw, leads=[lead for _, _, lead in rows])
        print(f"pad {pad} s, {replays} replays, spin {spin}: {len(short)} of"
              f" {len(rows)} windows short of {want} device kernels, "
              f"{sum(d < want_dw for d in dw)} short of {want_dw} #1 "
              f"kernels; #1 counts {dw}; kernels before the first #1 "
              f"{[lead for _, _, lead in rows]}", flush=True)
        for names, span, lead in short[:3]:
            lost = full - names
            print(f"  lost {sum(lost.values())}: "
                  f"{[(k[:60], n) for k, n in lost.most_common(4)]}; device "
                  f"{span[0]:.0f}-{span[1]:.0f} us, host to {span[2]:.0f}; "
                  f"{lead} kernels before the first #1", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
