"""Deployment bundles on the card, phase 26 of ``chip_smoke.py``: the
export CLI (``python -m tdanet_tpu_torch.export_bundle``) on three model
families and the eval recipe's model, a bundle served in a fresh
interpreter without model code (``probes/deploy_serve.py``), each engine
held against the model it was exported from, kernel #1 counted inside
every program, and ``audio_test --bundle`` against the model-code eval.

    python -m tdanet_tpu_torch.probes.deploy_path [--out record.json]

Alone, it makes what the earlier phases make in ``chip_smoke.py``: the
bench model (out 128, in 512, 16 blocks, depth 5, 4 ms, 16 kHz) and the
training recipe's model (8 kHz) with seeded random weights, and phase
18's corpus.

The phase:
  (a) five exports started at once, each a CLI subprocess: the bench
      model at 2.0 s, batch 8, early exit 8, the progressive pair at depth
      8 and a streaming program of 1 s x 4 streams, and again in bf16
      (2.0 s, batch 8, ``--dtype bfloat16``); TDANetYang and
      TDANetEMCADv1_6 at configs/tdanet_origin.yml's widths and 2 blocks
      (2.0 s, batch 1); the recipe's model at every length of phase 18's
      corpus (``--lengths_from_manifest``, batch 8). Each prints its
      programs' export seconds and sizes. The model's references are
      computed meanwhile, and (d) and (e) run as soon as their bundles
      are written, while the bench bundle still traces;
  (b) the bench bundle in a fresh interpreter: 8 utterances of 2 s
      against ``separate_batched`` on the model (>= 60 dB), the first
      against the model in float64 on the CPU (>= 60 dB), the E8 program
      against ``separate_batched(num_blocks=8)``, the progressive pair at
      thresholds 0, inf and the median stage-1 delta against
      ``separate_progressive`` (and its census), ``load_streaming`` on 4
      streams against the model's ``MultiStreamSeparator``; every output
      of its input's length;
  (c) #1 in each program: its op nodes (512 T and S, 256 E8 and each
      stage), its wrapper launches at each engine's set-up (a set-up
      forward and a capture: twice the nodes), none in replays, and the
      profiler's #1 device kernels per replay (the nodes);
  (d) the bf16 bundle against ``separate_batched(compute_dtype=bf16)``
      on the model, both on cuDNN's deterministic algorithms (>= 120 dB),
      beside two controls (the model's bf16 forward run twice on the
      default algorithms, and against its fp32 forward);
      TDANetYang's and TDANetEMCADv1_6's bundles against their models'
      ``separate`` (>= 60 dB each); 512, 34 and 44 nodes;
  (e) ``audio_test --bundle`` on phase 18's corpus against the model-code
      stream, every metric within 0.01 dB; three buckets, 2 x 512
      launches each;
  (f) times: the bundle's B=8 2 s replay against the model's graph
      replay, its load-to-first-result seconds, and the eager forward
      (B=1 2 s) with #1 through the registered op against #1 called
      directly, in turns.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tdanet_tpu_torch import audio_test, deploy, models
from tdanet_tpu_torch.kernels import _build
from tdanet_tpu_torch.kernels import dw_conv_glob_ln as dw
from tdanet_tpu_torch.models import BaseModel, TDANetBest
from tdanet_tpu_torch.probes import era, eval_path, variants
from tdanet_tpu_torch.probes.deploy_serve import drive_streams
from tdanet_tpu_torch.probes.serve_path import CFG
from tdanet_tpu_torch.probes.train_step import tone_mix
from tdanet_tpu_torch.progressive import separate_progressive
from tdanet_tpu_torch.serving import MultiStreamSeparator, Program
from tdanet_tpu_torch.utils import separate, separate_batched, trim_renorm
from tdanet_tpu_torch.utils.parser import load_yaml
from tdanet_tpu_torch.utils.timing import card_line, cuda_time, snr_db

SR = 16000
SECONDS = 2.0
BATCH = 8
DEPTH1 = 8
SEGMENT, STREAMS = 1.0, 4
STREAM_SECONDS = (2.3, 3.1, 4.4, 5.2)
FAMILY_BLOCKS = 2
# the two families beside TDANetBest: (constructor config, #1's sites a
# block iteration)
FAMILY = {"TDANetYang": (variants.CFG, variants.SITES["TDANetYang"]),
          "TDANetEMCADv1_6": (era.CFG, era.SITES["TDANetEMCADv1_6"])}
SITES_PER_BLOCK = 32
DEPTH_FULL = CFG["num_blocks"]
LIMIT_DB = 60.0
# the bf16 bundle against the model, both on cuDNN's deterministic
# algorithms: the model's op sequence on the same kernels, equal bit for
# bit on the H100 (probes/export_parity.py); with the default algorithms
# the decoder's transposed convolution alone differs from run to run
# (about 72 dB in bf16, 164 in fp32), and bf16 against fp32 is about
# 38 dB: an op in another precision or order falls far below the limit
BF16_LIMIT_DB = 120.0
EXPORT_TIMEOUT = 600


def _r(values):
    return [round(v, 2) for v in values]


def _expect(ok, what):
    if not ok:
        raise AssertionError(what)


def _snr(ref, est):
    return snr_db(torch.from_numpy(np.asarray(ref, np.float64)),
                  torch.from_numpy(np.asarray(est, np.float64)))


def _min_snr(refs, ests):
    for r, e in zip(refs, ests):
        _expect(np.shape(r) == np.shape(e),
                f"shapes {np.shape(r)} and {np.shape(e)}")
    return min(_snr(r, e) for r, e in zip(refs, ests))


class _Exports:
    """Export CLI subprocesses, started together, waited for in turn;
    ``close`` ends any still running."""

    def __init__(self):
        self.procs = {}

    def start(self, name, ckpt, out, *args):
        cmd = [sys.executable, "-m", "tdanet_tpu_torch.export_bundle",
               "--ckpt", ckpt, "--out", out, *map(str, args)]
        self.procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), time.perf_counter(), out)

    def wait(self, name):
        proc, t0, out = self.procs[name]
        text, err = proc.communicate(timeout=EXPORT_TIMEOUT)
        wall = time.perf_counter() - t0
        _expect(proc.returncode == 0,
                f"export of {name} failed ({proc.returncode}):\n"
                f"{err[-4000:]}")
        print(f"export {name}: {wall:.1f} s wall (five exports started "
              f"at once)")
        for line in text.splitlines():
            print(f"  {line}")
        with open(os.path.join(out, "meta.json")) as f:
            meta = json.load(f)
        return out, meta, wall

    def close(self):
        for proc, _, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def family_checkpoints(tmp):
    """TDANetYang and TDANetEMCADv1_6 at their full widths and
    FAMILY_BLOCKS blocks, seeded, written as .pth: {name: path}."""
    paths = {}
    for i, (name, (cfg, _)) in enumerate(FAMILY.items()):
        model = models.get(name)(**{**cfg, "num_blocks": FAMILY_BLOCKS})
        model.reset_parameters(torch.Generator().manual_seed(300 + i))
        paths[name] = os.path.join(tmp, f"deploy_{name}.pth")
        torch.save(model.serialize(), paths[name])
    return paths


def _launches(fn):
    before = dw.dw_conv_glob_ln.launches
    out = fn()
    torch.cuda.synchronize()
    return out, dw.dw_conv_glob_ln.launches - before


def bench_references(model, tmp):
    """The model's answers to what the bench bundle will be asked, on the
    card (and one utterance in float64 on the CPU), and the inputs file
    of the serving subprocess. Runs while the exports run."""
    wavs = np.stack([tone_mix(SECONDS, seed=60 + i) for i in range(BATCH)])
    target = -(-wavs.shape[1] // model.lcm) * model.lcm
    mixes = np.zeros((BATCH, target), np.float32)
    mixes[:, :wavs.shape[1]] = wavs
    streams = [tone_mix(s, seed=70 + i)
               for i, s in enumerate(STREAM_SECONDS)]
    with torch.inference_mode():
        ref = {"T": separate_batched(model, list(wavs), batch_size=BATCH),
               "E8": separate_batched(model, list(wavs), batch_size=BATCH,
                                      num_blocks=DEPTH1)}
        deltas = separate_progressive(model, mixes, depth1=DEPTH1,
                                      threshold=np.inf,
                                      batch_size=BATCH)[1]["delta"]
        thresholds = [0.0, float("inf"), float(np.median(deltas))]
        escalated = []
        for i, thr in enumerate(thresholds):
            ests, info = separate_progressive(
                model, mixes, depth1=DEPTH1, threshold=thr,
                batch_size=BATCH)
            ref[f"P{i}"] = [trim_renorm(w, e) for w, e in zip(wavs, ests)]
            escalated.append(info["n_escalated"])
        ref["S"] = drive_streams(MultiStreamSeparator(
            model, max_streams=STREAMS, segment=SEGMENT, overlap=0.25,
            sample_rate=SR), streams)
    cpu64 = copy.deepcopy(model).cpu().double()
    t0 = time.perf_counter()
    ref["cpu64"] = separate(cpu64, wavs[0])
    cpu_s = time.perf_counter() - t0
    del cpu64
    inputs = os.path.join(tmp, "deploy_inputs.npz")
    np.savez(inputs, wavs=wavs, thresholds=np.array(thresholds),
             **{f"stream{i}": s for i, s in enumerate(streams)})
    return dict(inputs=inputs, ref=ref, thresholds=thresholds,
                escalated=escalated, wavs=wavs, streams=streams,
                cpu_s=cpu_s, target=target)


def serve_bench(bundle, refs, tmp):
    """(b) and (c): the bench bundle in a fresh interpreter against the
    model's answers (:func:`bench_references`). Returns the record."""
    inputs, ref, thresholds = refs["inputs"], refs["ref"], refs["thresholds"]
    escalated, wavs, streams = (refs["escalated"], refs["wavs"],
                                refs["streams"])
    out = os.path.join(tmp, "deploy_served.npz")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tdanet_tpu_torch.probes.deploy_serve",
         bundle, inputs, out], capture_output=True, text=True,
        timeout=EXPORT_TIMEOUT)
    wall = time.perf_counter() - t0
    _expect(proc.returncode == 0,
            f"serving the bundle failed ({proc.returncode}):\n"
            f"{proc.stderr[-4000:]}")
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    rec = json.loads(str(got.pop("record")))
    print(f"served in a fresh interpreter ({wall:.1f} s with the "
          f"interpreter's start): load {rec['load_s']:.2f} s, load to "
          f"first result {rec['load_to_first_result_s']:.2f} s; "
          f"tdanet_tpu_torch.models imported: {rec['models_imported']}")
    _expect(not rec["models_imported"], "the bundle imported model code")

    agree = {"T_vs_separate_batched_db": _min_snr(ref["T"], got["T"]),
             "E8_vs_separate_batched_db": _min_snr(ref["E8"], got["E8"])}
    for i, thr in enumerate(thresholds):
        agree[f"P_{thr:.4g}_vs_separate_progressive_db"] = _min_snr(
            ref[f"P{i}"], got[f"P{i}"])
    agree["S_vs_MultiStreamSeparator_db"] = _min_snr(
        ref["S"], [got[f"S{i}"] for i in range(STREAMS)])
    for k, v in agree.items():
        print(f"  {k}: {v:.2f} dB (limit {LIMIT_DB:.0f})")
        _expect(v >= LIMIT_DB, f"{k} {v:.2f} dB")
    for i, s in enumerate(streams):
        _expect(got[f"S{i}"].shape == (2, s.shape[-1]),
                f"stream {i}: {got[f'S{i}'].shape} for {s.shape}")
    _expect(got["T"].shape == (BATCH, 2, wavs.shape[1]), "T's shape")
    _expect(rec["escalated"] == escalated,
            f"escalations {rec['escalated']}, the model's {escalated}")
    print(f"  progressive escalations at thresholds {thresholds}: "
          f"{escalated} of {BATCH}, as the model's")

    cpu_s = refs["cpu_s"]
    agree["T_vs_cpu64_db"] = _snr(ref["cpu64"], got["T"][0])
    print(f"  bundle vs the model in float64 on the CPU ({cpu_s:.1f} s): "
          f"{agree['T_vs_cpu64_db']:.2f} dB (limit {LIMIT_DB:.0f})")
    _expect(agree["T_vs_cpu64_db"] >= LIMIT_DB, "bundle vs CPU float64")

    depth = DEPTH_FULL
    nodes = {"T": SITES_PER_BLOCK * depth, "E8": SITES_PER_BLOCK * DEPTH1,
             "P_s1": SITES_PER_BLOCK * DEPTH1,
             "P_s2": SITES_PER_BLOCK * (depth - DEPTH1),
             "S": SITES_PER_BLOCK * depth}
    _expect(rec["nodes"] == nodes, f"#1 nodes {rec['nodes']}, expected "
                                   f"{nodes}")
    setup = {"T": 2 * nodes["T"], "E8": 2 * nodes["E8"],
             "P": 2 * (nodes["P_s1"] + nodes["P_s2"]), "S": 2 * nodes["S"]}
    _expect(rec["setup_launches"] == setup,
            f"set-up launches {rec['setup_launches']}, expected {setup}")
    _expect(rec["replay_launches"] == 0, "a replay passed the wrapper")
    _expect(rec["profiled"] == {k: float(v) for k, v in nodes.items()},
            f"profiled #1 device kernels a replay {rec['profiled']}, "
            f"expected {nodes}")
    print(f"  #1 op nodes {rec['nodes']}; wrapper launches at set-up "
          f"{rec['setup_launches']}, 0 in replays; device kernels a replay"
          f" (profiler) {rec['profiled']}")
    return {**agree, "cpu64_s": cpu_s, "served_wall_s": wall,
            "thresholds": thresholds, "escalated": escalated, **rec}


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms inside, the caller's setting
    after."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def serve_bf16(bundle, model, wavs):
    """The bench model's bf16 bundle (activations in bf16 over fp32
    weights, #1 on its bf16 storage) served here against
    ``separate_batched(compute_dtype=bf16)`` on the model, both with
    cuDNN's deterministic algorithms, at BF16_LIMIT_DB. Two controls are
    recorded beside it, with the default algorithms: the model's bf16
    forward against itself (the decoder's transposed convolution sums in
    an order that changes from run to run) and against its fp32 forward
    (what bf16 costs). Returns (its record, #1's wrapper launches)."""
    def model_bf16():
        with torch.inference_mode():
            return separate_batched(model, list(wavs), batch_size=BATCH,
                                    compute_dtype=torch.bfloat16)
    with _deterministic_cudnn():
        dep = deploy.load_bundle(bundle)
        got, n = _launches(lambda: dep.separate_batched(list(wavs)))
        want = model_bf16()
    db = _min_snr(want, got)
    rerun = _min_snr(model_bf16(), model_bf16())
    with torch.inference_mode():
        fp32 = separate_batched(model, list(wavs), batch_size=BATCH)
    precision = _min_snr(fp32, want)
    nodes = deploy.op_nodes(next(iter(dep.modules.values())))
    print(f"bf16 bench bundle vs separate_batched(compute_dtype=bf16), "
          f"deterministic cuDNN: {db:.2f} dB (limit {BF16_LIMIT_DB:.0f}); "
          f"controls, default cuDNN: the model's bf16 forward run twice "
          f"{rerun:.2f} dB, bf16 against fp32 {precision:.2f} dB; #1 nodes "
          f"{nodes}; wrapper launches {n}")
    _expect(db >= BF16_LIMIT_DB, f"the bf16 bundle disagrees: {db:.2f} dB")
    _expect(nodes == SITES_PER_BLOCK * DEPTH_FULL and n == 2 * nodes,
            f"bf16 bundle: {nodes} nodes, {n} launches")
    return {"vs_separate_batched_db": db, "model_rerun_db": rerun,
            "vs_fp32_db": precision, "nodes": nodes, "launches": n}, n


def serve_family(bundles, paths):
    """(d): each family bundle, served in this process, against its
    model's ``separate``. Returns ({name: record}, #1 launches)."""
    rec, launches = {}, 0
    for i, (name, (_, sites)) in enumerate(FAMILY.items()):
        model = BaseModel.from_pretrain(paths[name]).cuda().eval()
        wav = tone_mix(SECONDS, seed=80 + i)
        with torch.inference_mode():
            want = separate(model, wav)
        dep = deploy.load_bundle(bundles[name])
        got, n = _launches(lambda: dep.separate(wav))
        nodes = deploy.op_nodes(next(iter(dep.modules.values())))
        db = _snr(want, got)
        print(f"{name} ({FAMILY_BLOCKS} blocks) bundle vs the model's "
              f"separate: {db:.2f} dB (limit {LIMIT_DB:.0f}); #1 nodes "
              f"{nodes} ({sites} x {FAMILY_BLOCKS}); wrapper launches "
              f"{n}")
        _expect(got.shape == (2, wav.shape[-1]), f"{name}: {got.shape}")
        _expect(db >= LIMIT_DB, f"{name} bundle disagrees: {db:.2f} dB")
        _expect(nodes == sites * FAMILY_BLOCKS, f"{name}: {nodes} nodes")
        _expect(n == 2 * nodes, f"{name}: {n} wrapper launches")
        rec[name] = {"vs_separate_db": db, "nodes": nodes, "launches": n}
        launches += n
        del model, dep
        torch.cuda.empty_cache()
    return rec, launches


def _rows(exp_dir):
    with open(os.path.join(exp_dir, "results", "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    return {r["snt_id"]: r for r in rows[:-2]}


def eval_bundle(bundle, meta, eval_conf):
    """(e): ``audio_test --bundle`` against the model-code stream on
    phase 18's corpus. Returns (record, #1 launches of the bundle run)."""
    exp_dir = audio_test.experiment_dir(load_yaml(eval_conf))
    runs = {}
    for tag, argv in (("stream", ["--batch_size", str(BATCH)]),
                      ("bundle", ["--bundle", bundle])):
        _, wall, n, final = eval_path.run_cli(
            audio_test, ["--conf_dir", eval_conf, *argv], tag)
        _expect(audio_test.ok(final), f"{tag}: result {final}")
        runs[tag] = (_rows(exp_dir), wall, n)
    stream, bundle_rows = runs["stream"][0], runs["bundle"][0]
    _expect(sorted(stream) == sorted(bundle_rows), "the runs' utterances")
    diff = max(abs(float(stream[k][c]) - float(bundle_rows[k][c]))
               for k in stream for c in ("sdr", "sdr_i", "si-snr",
                                         "si-snr_i"))
    n_buckets = len(meta["targets"])
    want = 2 * SITES_PER_BLOCK * meta["model_args"]["num_blocks"] \
        * n_buckets
    print(f"  audio_test --bundle ({n_buckets} buckets {meta['targets']}) "
          f"vs the model-code stream: largest metric difference {diff:.3g}"
          f" dB (limit 0.01) over {len(stream)} utterances; wall "
          f"{runs['bundle'][1]:.3f} s vs {runs['stream'][1]:.3f} s")
    _expect(diff <= 0.01, f"bundle metrics differ by {diff} dB")
    _expect(runs["bundle"][2] == want,
            f"{runs['bundle'][2]} wrapper launches, expected {want}")
    return {"max_metric_diff_db": diff, "buckets": meta["targets"],
            "wall_s": runs["bundle"][1], "stream_wall_s": runs["stream"][1],
            "launches": runs["bundle"][2]}, runs["bundle"][2]


def time_op_dispatch(model, rounds=3):
    """(f): the host cost of #1's registered op. Host us a call of the op
    against #1's CUDA implementation called directly (the dispatcher
    bypassed, as the wrapper does outside a trace) at the served
    forward's finest site, (1, 2010, 512) K5 stride 1 in the model's
    layout, 2000 calls each; and the eager B=1 2 s forward both ways,
    median ms of 9 runs, in turns (op, direct) ``rounds`` times. Returns
    {"op_us": [...], "direct_us": [...], "op_ms": [...], "direct_ms":
    [...]}."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1, 512, 2010, generator=gen).cuda().transpose(1, 2)
    w, g, b = (torch.randn(512, 1, 5, generator=gen).cuda(),
               torch.ones(512, device="cuda"), torch.zeros(512, device="cuda"))
    wav = torch.from_numpy(tone_mix(SECONDS, seed=9)).cuda()[None]
    impl = dw._IMPL
    out = {"op_us": [], "direct_us": [], "op_ms": [], "direct_ms": []}
    try:
        with torch.inference_mode():
            for _ in range(rounds):
                for tag, fn in (("op", dw.OP), ("direct", dw._op_cuda)):
                    dw._IMPL = {**impl, "cuda": fn}
                    for _ in range(50):
                        fn(x, w, b, g, b, 1, 5, 1e-8)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(2000):
                        fn(x, w, b, g, b, 1, 5, 1e-8)
                    out[f"{tag}_us"].append(
                        (time.perf_counter() - t0) / 2000 * 1e6)
                    torch.cuda.synchronize()
                    ms, _, _ = cuda_time(lambda: model(wav), reps=1, runs=9,
                                         warmup=2)
                    out[f"{tag}_ms"].append(ms)
    finally:
        dw._IMPL = impl
    return out


def drive_deploy(card, tmp, bench_ckpt, eval_conf):
    """Phase 26: the bench checkpoint ``bench_ckpt`` and the eval conf
    of phase 18 (its corpus under ``tmp``). Returns (record, #1's wrapper
    launches on the phase's bundle paths)."""
    rec = {}
    dw.dw_conv_glob_ln.launches = 0
    ckpt = os.path.join(audio_test.experiment_dir(
        load_yaml(eval_conf)), "best_model.pth")
    corpus = load_yaml(eval_conf)["datamodule"]["data_config"][
        "test_dir"]
    paths = family_checkpoints(tmp)
    out = {name: os.path.join(tmp, f"bundle_{name}")
           for name in ("bench", "bf16", "corpus", *FAMILY)}
    exports = _Exports()
    try:
        exports.start("bench", bench_ckpt, out["bench"], "--lengths",
                      SECONDS, "--batch", BATCH, "--early_exit", DEPTH1,
                      "--progressive_depth", DEPTH1, "--streaming_segment",
                      SEGMENT, "--streaming_max_streams", STREAMS)
        exports.start("bf16", bench_ckpt, out["bf16"], "--lengths",
                      SECONDS, "--batch", BATCH, "--dtype", "bfloat16")
        exports.start("corpus", ckpt, out["corpus"],
                      "--lengths_from_manifest",
                      os.path.join(corpus, "mix_clean.json"),
                      "--batch", BATCH)
        for name in FAMILY:
            exports.start(name, paths[name], out[name], "--lengths",
                          SECONDS, "--batch", 1)
        # the model's answers on the card while the exports trace
        model = BaseModel.from_pretrain(bench_ckpt).cuda().eval()
        refs = bench_references(model, tmp)
        metas = {name: exports.wait(name)
                 for name in ("bf16", *FAMILY, "corpus")}
        # the finished bundles served here while the bench bundle (the
        # longest export) still traces: their checks claim no time
        rec["bf16"], launches = serve_bf16(out["bf16"], model,
                                           refs["wavs"])
        rec["family"], n = serve_family(out, paths)
        launches += n
        rec["eval"], n = eval_bundle(out["corpus"], metas["corpus"][1],
                                     eval_conf)
        launches += n
        metas["bench"] = exports.wait("bench")
    finally:
        exports.close()
    rec["export"] = {name: {"wall_s": wall, "programs": meta["programs"],
                            "kernels": meta["kernels"]}
                     for name, (_, meta, wall) in metas.items()}
    for name, (_, meta, _) in metas.items():
        _expect(meta["kernels"]["dw_conv_glob_ln"]["source_hash"]
                == _build.source_hash("dw_conv_glob_ln"),
                f"{name}: the recorded kernel source")

    # the fresh interpreter alone on the machine: its times are claimed
    rec["bench"] = serve_bench(out["bench"], refs, tmp)
    launches += sum(rec["bench"]["setup_launches"].values())

    # the model's forward captured as the bundle's is (serving.Program)
    # and its replay timed the same way
    prog = Program(lambda x: model(x, per_utterance=True), BATCH,
                   rec["bench"]["target"], torch.device("cuda"))
    gms, gruns, _ = cuda_time(prog.graph.replay, reps=5)
    del prog
    dispatch = time_op_dispatch(model)
    rec["times"] = {"bundle_replay_ms": rec["bench"]["replay_ms"],
                    "model_replay_ms": gms, "model_replay_runs_ms": gruns,
                    "load_to_first_result_s":
                        rec["bench"]["load_to_first_result_s"],
                    **{f"dispatch_{k}": v for k, v in dispatch.items()}}
    print(f"  [{card}] B={BATCH} {SECONDS} s forward: bundle replay "
          f"{rec['bench']['replay_ms']:.2f} ms, the model's graph replay "
          f"{gms:.2f} ms; load to first result "
          f"{rec['bench']['load_to_first_result_s']:.2f} s")
    print(f"  [{card}] #1 at (1, 2010, 512) K5 s1, host us a call in "
          f"turns: through the op {_r(dispatch['op_us'])}, called directly "
          f"{_r(dispatch['direct_us'])}; the eager B=1 {SECONDS} s forward, "
          f"ms: through the op {_r(dispatch['op_ms'])}, directly "
          f"{_r(dispatch['direct_ms'])}")
    print(f"phase 26: #1's wrapper launched {launches} times on the bundle "
          f"paths (set-ups and captures; replays pass no wrapper)")
    return rec, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the record as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    _build.build("dw_conv_glob_ln")  # once, before the exporters start
    with tempfile.TemporaryDirectory() as tmp:
        bench = TDANetBest(**CFG)
        bench.reset_parameters(torch.Generator().manual_seed(1234))
        bench_ckpt = os.path.join(tmp, "bench.pth")
        torch.save(bench.serialize(), bench_ckpt)
        conf = eval_path.random_experiment(tmp)
        lattice = BaseModel.from_pretrain(os.path.join(
            os.path.dirname(conf), "best_model.pth")).lcm
        eval_conf = eval_path.eval_corpus(conf, lattice, tmp)[0]
        record, launches = drive_deploy(card, tmp, bench_ckpt, eval_conf)
    record = {"card": card, "launches": launches, **record}
    print(json.dumps(record))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
