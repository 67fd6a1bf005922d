"""Profiled windows of TDANetYang's CUDA-graph replays, with and without
idle host time at the window's ends: how many device kernels each window
keeps (ROADMAP C #8).

    python -m tdanet_tpu_torch.probes.profiler_windows [--windows 30]
        [--out record.json]

Phase 22's profiled forward: TDANetYang at ``configs/tdanet_origin.yml``'s
widths (out 128, in 512, 16 blocks, depth 5) at 16 kHz, seeded random
weights, B=1 2 s, captured in one CUDA graph. Windows of 3 replays
alternate between no idle time and ``timing.WINDOW_PAD_S`` at each end.
A window can only lose kernels, so the most that any window counted is
what the replays launch; a window below it lost events. For each short
window the kernels it lacks are printed by name, with the window's first
device start, last device end and last host end (us from the window's
first host event)."""

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


def window(graph, pad_s):
    """One window of PROFILED_REPLAYS replays: (device kernels by name,
    (first device start, last device end, last host end) in us from the
    window's first host event)."""
    with torch.inference_mode(), profiled(pad_s) as prof:
        for _ in range(PROFILED_REPLAYS):
            graph.replay()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if e.device_type == cuda]
    host = [e for e in events if e.device_type != cuda]
    host0 = min((e.time_range.start for e in host), default=0.0)
    host1 = max((e.time_range.end for e in host), default=0.0)
    names = collections.Counter(e.name for e in dev)
    span = (min(e.time_range.start for e in dev) - host0,
            max(e.time_range.end for e in dev) - host0,
            host1 - host0) if dev else (0, 0, 0)
    return names, span


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=30,
                    help="windows of each kind")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this probe runs on a GPU")
    card = card_line()
    print(card, flush=True)
    _, graph = capture()
    reads = []
    for i in range(2 * args.windows):
        pad = 0.0 if i % 2 == 0 else WINDOW_PAD_S
        names, span = window(graph, pad)
        reads.append((pad, names, span))
    full = collections.Counter()
    for _, names, _ in reads:
        full = full | names
    want_dw = sum(n for k, n in full.items() if "dw_conv_glob_ln" in k)
    want = sum(full.values())
    record = {"card": card, "replays": PROFILED_REPLAYS,
              "most_kernels": want, "most_dw": want_dw, "pads": {}}
    for pad in (0.0, WINDOW_PAD_S):
        rows = [(names, span) for p, names, span in reads if p == pad]
        short = [(names, span) for names, span in rows
                 if sum(names.values()) < want]
        dw = [sum(n for k, n in names.items() if "dw_conv_glob_ln" in k)
              for names, _ in rows]
        record["pads"][str(pad)] = dict(
            windows=len(rows), short_windows=len(short),
            short_dw_windows=sum(d < want_dw for d in dw),
            lost_kernels=[want - sum(names.values()) for names, _ in short],
            dw_counts=dw)
        print(f"pad {pad} s: {len(short)} of {len(rows)} windows short of "
              f"{want} device kernels, {sum(d < want_dw for d in dw)} short "
              f"of {want_dw} #1 kernels; #1 counts {dw}", flush=True)
        for names, span in short[:6]:
            lost = full - names
            print(f"  lost {sum(lost.values())}: "
                  f"{[(k[:60], n) for k, n in lost.most_common(4)]}; device "
                  f"{span[0]:.0f}-{span[1]:.0f} us, host to {span[2]:.0f}",
                  flush=True)
    full_spans = [span for _, names, span in reads
                  if sum(names.values()) == want][:4]
    print(f"full windows' device spans (us): {full_spans}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
