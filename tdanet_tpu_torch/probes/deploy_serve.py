"""A deployment bundle served in a fresh interpreter, with no model code:
the serving half of ``chip_smoke.py`` phase 26 (``probes/deploy_path.py``
drives it and holds its outputs against the model's).

    python -m tdanet_tpu_torch.probes.deploy_serve BUNDLE INPUTS.npz \\
        OUT.npz [--device cuda]

INPUTS.npz holds ``wavs`` (N, T) (one length, the bundle's bucket),
``thresholds`` (the progressive runs' thresholds) and ``stream<i>`` (the
live streams' audio). The bundle must hold T and E8-style buckets for
that length, the progressive pair and a streaming program. Each engine is
loaded, its programs' #1 nodes counted, its first call's wrapper launches
counted (on the card a program's set-up forward and its capture), and on
the card a profiled window of graph replays counts #1's device kernels
per replay (a short window is read once more: the profiler may drop an
event; a second short one fails); a B-row forward is timed by replay. OUT.npz gets every
estimate and a JSON record under ``record``. The run fails if it imported
``tdanet_tpu_torch.models``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from tdanet_tpu_torch import deploy
from tdanet_tpu_torch.kernels.dw_conv_glob_ln import dw_conv_glob_ln
from tdanet_tpu_torch.utils.timing import (counted_windows, cuda_time,
                                          profile_window)

# ragged pushes of the streams (samples), as serving's probe pushes them
RAGGED = (5000, 17000, 3100, 26000, 900, 40000)
PROFILED_REPLAYS = 3


def drive_streams(engine, wavs):
    """Interleaved ragged pushes with steps, then a flush of each stream:
    each stream's (n_src, T) output."""
    got = {i: [] for i in range(len(wavs))}
    pos = [0] * len(wavs)
    for i in range(len(wavs)):
        engine.open(i)
    k = 0
    while any(p < len(w) for p, w in zip(pos, wavs)):
        for i, w in enumerate(wavs):
            chunk = w[pos[i]:pos[i] + RAGGED[(k + i) % len(RAGGED)]]
            pos[i] += len(chunk)
            if len(chunk):
                engine.push(i, chunk)
        k += 1
        for sid, out in engine.step().items():
            got[sid].append(out)
    return [np.concatenate(got[i] + [engine.flush(i)], axis=1)
            for i in range(len(wavs))]


def _launched(fn):
    """(fn's return, #1's wrapper launches in it)."""
    before = dw_conv_glob_ln.launches
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, dw_conv_glob_ln.launches - before


def _profiled(graph, nodes, what):
    """#1's device kernels per replay of ``graph``, from a window of
    PROFILED_REPLAYS replays, held to ``nodes`` a replay by
    ``timing.counted_windows`` (a short window is read once more: the
    profiler may drop an event; a second short one fails)."""
    def run():
        for _ in range(PROFILED_REPLAYS):
            graph.replay()

    def read():
        _, dw, _, _, _ = profile_window(run)
        return dw, nodes * PROFILED_REPLAYS, dw / PROFILED_REPLAYS
    return counted_windows(read, f"bundle {what} replays")


def serve(bundle, inputs, device):
    """Every engine of the bundle on ``inputs``: (estimates, record)."""
    cuda = torch.device(device).type == "cuda"
    wavs = list(inputs["wavs"])
    streams = [inputs[k] for k in sorted(inputs)
               if k.startswith("stream")]
    out, rec = {}, {"nodes": {}, "setup_launches": {}, "profiled": {}}

    t0 = time.perf_counter()
    dep = deploy.load_bundle(bundle, device=device)
    t_load = time.perf_counter() - t0
    ests, rec["setup_launches"]["T"] = _launched(
        lambda: dep.separate_batched(wavs))
    rec["load_s"] = t_load
    rec["load_to_first_result_s"] = time.perf_counter() - t0
    out["T"] = np.stack(ests)
    (target, module), = dep.modules.items()
    rec["target"] = target
    rec["nodes"]["T"] = deploy.op_nodes(module)
    _, rec["replay_launches"] = _launched(
        lambda: dep.separate_batched(wavs))
    if cuda:
        graph = dep.programs[target].graph
        ms, runs, _ = cuda_time(graph.replay, reps=5)
        rec["replay_ms"], rec["replay_runs_ms"] = ms, runs
        rec["profiled"]["T"] = _profiled(graph, rec["nodes"]["T"], "T")

    dep8 = deploy.load_bundle(bundle, device=device, num_blocks=8)
    ests, rec["setup_launches"]["E8"] = _launched(
        lambda: dep8.separate_batched(wavs))
    out["E8"] = np.stack(ests)
    rec["nodes"]["E8"] = deploy.op_nodes(dep8.modules[target])
    if cuda:
        rec["profiled"]["E8"] = _profiled(dep8.programs[target].graph,
                                          rec["nodes"]["E8"], "E8")
    del dep, dep8

    prog = deploy.load_progressive(bundle, device=device)
    m1, m2 = prog.stages[target]
    rec["nodes"]["P_s1"], rec["nodes"]["P_s2"] = (deploy.op_nodes(m1),
                                                  deploy.op_nodes(m2))
    rec["escalated"] = []
    for i, thr in enumerate(inputs["thresholds"]):
        stats = {}
        ests, n = _launched(lambda: prog.separate_batched(
            wavs, threshold=float(thr), stats=stats))
        if i == 0:
            rec["setup_launches"]["P"] = n
        out[f"P{i}"] = np.stack(ests)
        rec["escalated"].append(stats["n_escalated"])
    if cuda:
        g1, g2 = prog.graphs[target]
        rec["profiled"]["P_s1"] = _profiled(g1.graph, rec["nodes"]["P_s1"],
                                            "P_s1")
        rec["profiled"]["P_s2"] = _profiled(g2.graph, rec["nodes"]["P_s2"],
                                            "P_s2")
    del prog

    engine, rec["setup_launches"]["S"] = _launched(
        lambda: deploy.load_streaming(bundle, device=device))
    rec["nodes"]["S"] = deploy.op_nodes(engine.module)
    for i, o in enumerate(drive_streams(engine, streams)):
        out[f"S{i}"] = o
    rec["stream_replays"] = engine.stats["replays"]
    if cuda:
        rec["profiled"]["S"] = _profiled(engine._prog.graph,
                                         rec["nodes"]["S"], "S")
    rec["models_imported"] = "tdanet_tpu_torch.models" in sys.modules
    return out, rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bundle")
    ap.add_argument("inputs")
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # as chip_smoke.py's phase 1 sets it for the model this is held
    # against: TF32 off (cuDNN's convolutions default to it, about 67 dB)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with np.load(args.inputs) as z:
        inputs = {k: z[k] for k in z.files}
    out, rec = serve(args.bundle, inputs, args.device)
    np.savez(args.out, record=np.array(json.dumps(rec)), **out)
    print(json.dumps(rec))
    if rec["models_imported"]:
        raise SystemExit("serving the bundle imported tdanet_tpu_torch.models")


if __name__ == "__main__":
    main()
