"""The eval slice on the card, phases 18 and 19 of ``chip_smoke.py``: the
corpus eval CLI (``tdanet_tpu_torch.audio_test``) as a stream, a loop, at
an early-exit depth and progressively, and the long-form CSS CLI
(``tdanet_tpu_torch.audio_test_css``), each checked against the others
and against float64 on the CPU, with kernel #1's launches counted.

    python -m tdanet_tpu_torch.probes.eval_path [--out record.json]

Alone, it evaluates the training recipe's model at full width (out 128, in
512, 16 blocks, depth 5, 4 ms, 8 kHz, 2 sources) with seeded random
weights; ``chip_smoke.py`` gives it the model its phase 16 trained.

Phase 18's corpus: 24 tone-plus-noise utterances drawn from three cells of
the model's stride lattice (1024 samples at 8 kHz): 11 of about 2.5 s, 8 of
4 s and 5 of 6 s, each of its own length. At a batch of 8 that is three
buckets and four batches, a full one of 8 and ragged ones of 3 and 5.
Phase 19: two recordings of about 30 s and 47 s, 4 s segments, overlap
0.25; the first recording's first 4 segments are held against float64
stitching on the CPU (the full-width model in float64 is slow there: a
part of one recording keeps the phase short), both recordings against
stitching of their segments separated again on the card at fixed
depths.

Before its CLI runs, each phase holds #1 against its plain version at
every depthwise site a forward of its lengths runs, at every row count a
run can give them (1 to 8), fp32 in the model's layout; the runs then
record the sites they launch #1 at, and a site outside that set fails the
phase.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import io
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from tdanet_tpu_torch import audio_test, audio_test_css
from tdanet_tpu_torch.datas import LibriCSSDataset
from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_reference)
from tdanet_tpu_torch.metrics import MetricsTracker
from tdanet_tpu_torch.metrics import wrapper as metrics_wrapper
from tdanet_tpu_torch.models import BaseModel, TDANetBest, components
from tdanet_tpu_torch.probes.dw_sites import block_sites
from tdanet_tpu_torch.progressive import separate_progressive
from tdanet_tpu_torch.utils import (plan_lattice_buckets, read_wav,
                                    separate, write_wav)
from tdanet_tpu_torch.utils.css import chain_swaps, separate_segments, \
    stitch_chain
from tdanet_tpu_torch.utils.parser import load_yaml, save_yaml
from tdanet_tpu_torch.utils.timing import card_line, snr_db

SR = 8000
CELLS = ((2.5, 11), (4.0, 8), (6.0, 5))  # (seconds, utterances) a cell
MAX_SECONDS = 6.0
BATCH = 8
DEPTH1 = 8
CSS_SECONDS = (30.0, 47.0)
# the segments of the first recording held against float64 on the CPU
# (about 6 s of the CPU a segment at full width; the first 4 of its 10
# keep phase 19 within chip_smoke.py's time limit)
CPU64_SEGMENTS = 4
SEGMENT, OVERLAP = 4.0, 0.25
RECIPE = dict(out_channels=128, in_channels=512, num_blocks=16,
              upsampling_depth=5, enc_kernel_size=4, num_sources=2,
              sample_rate=SR)


def sites_per_block(model):
    """#1's launches per block iteration: the pyramid's depth stages, 3 a
    fusion LA (depth of them) and 3 an expansion LA (depth - 1): 32 at
    depth 5."""
    d = model.upsampling_depth
    return d + 3 * d + 3 * (d - 1)


def site_key(x, K, stride, bias, **_):
    """What decides a #1 launch's grid and code: (B, T, K, stride, bias,
    T innermost, dtype); TDANetBest's sites all run at eps 1e-8."""
    B, T, _ = x.shape
    return (B, T, K, stride, bias, x.stride(1) == 1, str(x.dtype))


def eval_sites(model, rows_by_length):
    """The site keys of every forward of B rows of a length-L input, for
    each L and its row counts in ``rows_by_length``, fp32 in the model's
    (B, C, T) layout: the finest length from the model's front end, then
    each UConvBlock's chain of depthwise sites."""
    device = next(model.parameters()).device
    keys = set()
    with torch.inference_mode():
        for length, rows in rows_by_length.items():
            T0 = model._front(torch.zeros(1, length, device=device))[0] \
                .shape[-1]
            for T, K, stride, bias in set(block_sites(
                    T0, model.upsampling_depth)):
                keys |= {(B, T, K, stride, bias, True, "torch.float32")
                         for B in rows}
    return keys


@contextlib.contextmanager
def recorded_sites():
    """Records the site key of every #1 call the model makes inside."""
    fn, seen = components.dw_conv_glob_ln, set()

    def record(x, weight, bias, gamma, beta, *, stride=1, K=5, **kw):
        seen.add(site_key(x, K, stride, bias is not None))
        return fn(x, weight, bias, gamma, beta, stride=stride, K=K, **kw)

    components.dw_conv_glob_ln = record
    try:
        yield seen
    finally:
        components.dw_conv_glob_ln = fn


def check_sites(keys, C, what, seed=0):
    """#1 against its plain version at every fp32 (B, C, T)-layout site of
    ``keys``, on seeded operands made on the card: phase 3's limit,
    max |d| <= 1e-4 max |ref|."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    worst, n = 0.0, 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for B, T, K, stride, bias, _, _ in sorted(keys):
            x = randn(B, C, T).transpose(1, 2)
            params = (randn(C, 1, K) * 0.2, randn(C) * 0.1 if bias else
                      None, randn(C), randn(C))
            got = dw_conv_glob_ln(x, *params, stride=stride, K=K)
            ref = dw_conv_glob_ln_reference(x, *params, stride=stride, K=K)
            err = (got - ref).abs().max().item()
            lim = 1e-4 * ref.abs().max().item()
            if not err <= lim:
                raise AssertionError(f"#1 disagrees with plain at B={B} "
                                     f"T={T} K={K} s={stride} bias={bias}:"
                                     f" max|d| {err:.3e}, limit {lim:.3e}")
            worst, n = max(worst, err / lim), n + 1
    torch.cuda.synchronize()
    print(f"  #1 against plain at the {n} {what} site shapes (B "
          f"{sorted({k[0] for k in keys})}, T {sorted({k[1] for k in keys})}"
          f", fp32, (B,C,T)): max|d| at most {worst:.3f} of the limit; "
          f"{time.perf_counter() - t0:.2f} s wall")


def expect_checked(seen, checked, what):
    """Every site the runs launched #1 at was held against plain."""
    missing = seen - checked
    if missing:
        raise AssertionError(f"{what} ran #1 at sites not held against "
                             f"plain: {sorted(missing)}")


def _tones(T, rng, sr=SR):
    """Two tone-plus-noise sources of T samples; a tone's frequency
    changes every 2 s, so a long recording has more than one scene."""
    t = np.arange(T) / sr
    srcs = []
    for _ in range(2):
        f = rng.uniform(80, 400, size=int(T // (2 * sr)) + 1)
        phase = np.cumsum(2 * np.pi * f[(t // 2).astype(int)] / sr)
        srcs.append(0.3 * np.sin(phase + rng.uniform(0, 6))
                    + 0.02 * rng.standard_normal(T))
    return srcs


def corpus_lengths(lattice, seed):
    """The phase's 24 lengths: for each cell, distinct sample counts
    inside the lattice cell that holds its length, no longer than
    MAX_SECONDS; shuffled, so corpus order is not bucket order."""
    rng = np.random.default_rng(seed)
    lengths = []
    for seconds, n in CELLS:
        k = -(-int(seconds * SR) // lattice)
        lo, hi = (k - 1) * lattice + 1, min(k * lattice, int(MAX_SECONDS
                                                              * SR))
        lengths += [int(v) for v in rng.choice(np.arange(lo, hi + 1), n,
                                               replace=False)]
    return [lengths[i] for i in rng.permutation(len(lengths))]


def write_corpus(root, lengths, seed):
    """Mixtures, sources and the manifests the data modules read."""
    rng = np.random.default_rng(seed)
    infos = {"mix_clean": [], "s1": [], "s2": []}
    for i, T in enumerate(lengths):
        s1, s2 = _tones(T, rng)
        for key, data in (("mix_clean", s1 + s2), ("s1", s1), ("s2", s2)):
            path = os.path.join(root, key, f"utt{i:02d}.wav")
            write_wav(path, data, SR)
            infos[key].append([path, T])
    for key, rows in infos.items():
        with open(os.path.join(root, f"{key}.json"), "w") as f:
            json.dump(rows, f)


class _Tee(io.StringIO):
    """Captures what a CLI prints and passes it on."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, s):
        self.out.write(s)
        return super().write(s)


def _read_outputs(root):
    """{wav name: (n_src, T)} of a CLI's s1/, s2/ folders."""
    out = {}
    for name in sorted(os.listdir(os.path.join(root, "s1"))):
        out[name] = np.stack([read_wav(os.path.join(root, f"s{s}",
                                                    name))[0]
                              for s in (1, 2)])
    return out


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


class _Split:
    """Where a stream's wall time goes: the forward on the card's clock
    (CUDA events around every TDANetBest.forward), the tracker (SI-SNR PIT
    and BSS-eval, apart), wav reads (the reader thread: they overlap the
    rest) and wav writes. Installed around one CLI run."""

    def __init__(self):
        self.events, self.bss, self.tracker = [], 0.0, 0.0
        self.read, self.write = 0.0, 0.0

    @contextlib.contextmanager
    def installed(self):
        from tdanet_tpu_torch.datas import datasets
        saved = (TDANetBest.forward, MetricsTracker.__call__,
                 metrics_wrapper.sdr_pit, datasets.read_wav,
                 audio_test.write_wav)
        fwd, call, bss, rd, wr = saved

        def forward(model, *a, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fwd(model, *a, **kw)
            end.record()
            self.events.append((start, end))
            return out

        def timed(fn, field):
            def inner(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    setattr(self, field, getattr(self, field)
                            + time.perf_counter() - t0)
            return inner

        TDANetBest.forward = forward
        MetricsTracker.__call__ = timed(call, "tracker")
        metrics_wrapper.sdr_pit = timed(bss, "bss")
        datasets.read_wav = timed(rd, "read")
        audio_test.write_wav = timed(wr, "write")
        try:
            yield self
        finally:
            (TDANetBest.forward, MetricsTracker.__call__,
             metrics_wrapper.sdr_pit, datasets.read_wav,
             audio_test.write_wav) = saved

    def forward_s(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


def run_cli(cli, argv, what):
    """One CLI run from a #1 launch count of 0: (printed text, wall s,
    launches, its return)."""
    torch.cuda.synchronize()
    dw_conv_glob_ln.launches = 0
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        ret = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dw_conv_glob_ln.launches
    print(f"  {what}: {wall:.3f} s wall, #1 launches {launches}")
    return tee.getvalue(), wall, launches, ret


def _expect(got, want, what):
    if got != want:
        raise AssertionError(f"{what}: {got}, expected {want}")


def _escalated(text):
    line = next(ln for ln in text.splitlines()
                if ln.startswith("progressive:"))
    return int(line.split("escalated ")[1].split("/")[0])


def _finite_csv(rows, n):
    if [r["snt_id"] for r in rows[-2:]] != ["avg", "std"] \
            or len(rows) != n + 2:
        raise AssertionError(f"metrics.csv has {len(rows)} rows, expected "
                             f"{n} and avg, std")
    vals = [float(v) for r in rows for k, v in r.items() if k != "snt_id"]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError("a metric is not finite")


def _snr_rows(ref, est):
    """The lower SNR of the two sources, (2, T) against (2, T)."""
    return min(snr_db(torch.from_numpy(np.asarray(ref[s], np.float64)),
                      torch.from_numpy(np.asarray(est[s], np.float64)))
               for s in range(len(ref)))


def _min_snr(ref, est, keys):
    return min(snr_db(torch.from_numpy(np.asarray(ref[k], np.float64)),
                      torch.from_numpy(np.asarray(est[k], np.float64)))
               for k in keys)


def eval_corpus(conf_path, lattice, tmp):
    """Phase 18's corpus, written to ``tmp/eval_corpus``, and a copy of
    the conf whose splits all read it, ``tmp/eval_conf.yml``. Returns
    (that conf's path, the corpus directory, the lengths)."""
    conf = load_yaml(conf_path)
    corpus = os.path.join(tmp, "eval_corpus")
    lengths = corpus_lengths(lattice, seed=18)
    write_corpus(corpus, lengths, seed=18)
    # setup() reads every split's manifest; the eval reads the test split
    conf["datamodule"]["data_config"].update(
        train_dir=corpus, valid_dir=corpus, test_dir=corpus)
    eval_conf = os.path.join(tmp, "eval_conf.yml")
    save_yaml(eval_conf, conf)
    return eval_conf, corpus, lengths


def drive_eval(card, conf_path, tmp):
    """Phase 18 on the experiment of ``conf_path`` (its best_model.pth).
    Returns the phase's record: #1's launches in its counted runs, the
    agreements, times and the progressive census."""
    conf = load_yaml(conf_path)
    exp_dir = audio_test.experiment_dir(conf)
    ckpt = os.path.join(exp_dir, "best_model.pth")
    model = BaseModel.from_pretrain(ckpt).cuda()
    lattice, depth = model.lcm, model.num_blocks
    per_iter = sites_per_block(model)
    eval_conf, corpus, lengths = eval_corpus(conf_path, lattice, tmp)
    n, audio_s = len(lengths), sum(lengths) / SR
    plan = plan_lattice_buckets(lengths, lattice, BATCH)
    groups = plan_lattice_buckets(lengths, lattice, 4 * BATCH)
    print(f"corpus: {n} utterances, {audio_s:.1f} s of audio, lengths "
          f"{sorted(lengths)}; lattice {lattice}; {len(groups)} buckets of "
          f"{[len(c) for _, c in groups]}; at batch {BATCH}: "
          f"{[len(c) for _, c in plan]} rows a batch")
    # every row count a run can give a bucket: the stream's chunks, the
    # loop's 1 and stage 2's gathered subsets
    most = {}
    for target, idx in groups:
        most[target] = max(most.get(target, 0), min(BATCH, len(idx)))
    checked = eval_sites(model, {t: range(1, k + 1)
                                 for t, k in most.items()})
    check_sites(checked, model.in_channels, "eval")

    def cli(tag, *args, split=None):
        out = os.path.join(tmp, f"sep_{tag}")
        argv = ["--conf_dir", eval_conf, "--save_output", "true",
                "--save_path", out, *args]
        with (split.installed() if split else contextlib.nullcontext()), \
                recorded_sites() as seen:
            text, wall, launches, final = run_cli(audio_test, argv, tag)
        expect_checked(seen, checked, tag)
        rows = _csv(os.path.join(exp_dir, "results", "metrics.csv"))
        _finite_csv(rows, n)
        if not audio_test.ok(final):
            raise AssertionError(f"{tag}: result {final}")
        return dict(text=text, wall=wall, launches=launches, final=final,
                    rows={r["snt_id"]: r for r in rows[:-2]},
                    order=[r["snt_id"] for r in rows[:-2]],
                    est=_read_outputs(out))

    split = _Split()
    runs = {"stream": cli("stream", "--batch_size", str(BATCH), split=split)}
    fwd_s = split.forward_s()
    runs["loop"] = cli("loop", "--batch_size", "1")
    runs["depth8"] = cli("depth8", "--batch_size", str(BATCH),
                         "--num_blocks", str(DEPTH1))
    _expect(runs["stream"]["launches"], per_iter * depth * len(plan),
            "#1 launches of the stream")
    _expect(runs["loop"]["launches"], per_iter * depth * n,
            "#1 launches of the loop")
    _expect(runs["depth8"]["launches"], per_iter * DEPTH1 * len(plan),
            "#1 launches at --num_blocks 8")
    keys = sorted(runs["stream"]["est"])

    # the deltas the progressive runs will see: stage 1 on the same groups
    deltas = {}
    for target, idx in groups:
        mixes = np.zeros((len(idx), target), np.float32)
        for row, i in enumerate(idx):
            mixes[row, :lengths[i]] = read_wav(os.path.join(
                corpus, "mix_clean", f"utt{i:02d}.wav"))[0]
        info = separate_progressive(model, mixes, depth1=DEPTH1,
                                    threshold=np.inf, batch_size=BATCH)[1]
        deltas.update(zip(idx, info["delta"].tolist()))
    median = float(np.median(list(deltas.values())))
    stage1_batches = sum(-(-len(idx) // BATCH) for _, idx in groups)
    for tag, thr in (("prog_0", 0.0), ("prog_inf", math.inf),
                     ("prog_median", median)):
        runs[tag] = cli(tag, "--batch_size", str(BATCH),
                        "--progressive_depth", str(DEPTH1),
                        "--progressive_threshold", repr(thr))
        hard = [[i for i in idx if thr <= 0 or deltas[i] > thr]
                for _, idx in groups]
        n_hard = sum(map(len, hard))
        _expect(_escalated(runs[tag]["text"]), n_hard,
                f"escalated at threshold {thr}")
        stage2_batches = sum(-(-len(h) // BATCH) for h in hard)
        _expect(runs[tag]["launches"],
                per_iter * (DEPTH1 * stage1_batches
                            + (depth - DEPTH1) * stage2_batches),
                f"#1 launches, progressive at threshold {thr}")
        runs[tag].update(n_hard=n_hard, stage2_batches=stage2_batches,
                         hard={f"utt{i:02d}.wav" for h in hard for i in h})
    if not 1 <= runs["prog_median"]["n_hard"] <= n - 1:
        raise AssertionError("the median threshold escalated "
                             f"{runs['prog_median']['n_hard']} of {n}")
    # at the median, each utterance's estimate is the full-depth stream's
    # (escalated: gathered to stage 2 and scattered back) or depth 8's
    median_ref = {k: runs["stream" if k in runs["prog_median"]["hard"]
                          else "depth8"]["est"][k] for k in keys}

    stream, loop = runs["stream"], runs["loop"]
    if stream["order"] != [f"utt{i:02d}.wav" for _, c in plan for i in c]:
        raise AssertionError("the stream's rows are not in bucket order")
    agree = {
        "stream_vs_loop_min_snr_db": _min_snr(loop["est"], stream["est"],
                                              keys),
        "prog0_vs_stream_min_snr_db": _min_snr(
            stream["est"], runs["prog_0"]["est"], keys),
        "prog_inf_vs_depth8_min_snr_db": _min_snr(
            runs["depth8"]["est"], runs["prog_inf"]["est"], keys),
        "prog_median_vs_fixed_depth_min_snr_db": _min_snr(
            median_ref, runs["prog_median"]["est"], keys)}
    metric_diff = max(abs(float(stream["rows"][k][c])
                          - float(loop["rows"][k][c]))
                      for k in keys for c in ("sdr", "sdr_i", "si-snr",
                                              "si-snr_i"))
    agree["stream_vs_loop_max_metric_diff_db"] = metric_diff
    for k, v in agree.items():
        print(f"  {k}: {v:.6g}")
    for k in ("stream_vs_loop_min_snr_db", "prog0_vs_stream_min_snr_db",
              "prog_inf_vs_depth8_min_snr_db",
              "prog_median_vs_fixed_depth_min_snr_db"):
        if not agree[k] >= 60.0:
            raise AssertionError(f"{k} {agree[k]:.2f} dB, limit 60")
    if not metric_diff <= 0.01:
        raise AssertionError(f"stream and loop metrics differ by "
                             f"{metric_diff} dB, limit 0.01")

    # the longest utterance against float64 on the CPU
    i_long = int(np.argmax(lengths))
    key = f"utt{i_long:02d}.wav"
    mix = read_wav(os.path.join(corpus, "mix_clean", key))[0]
    clean = np.stack([read_wav(os.path.join(corpus, s, key))[0]
                      for s in ("s1", "s2")])
    cpu64 = copy.deepcopy(model).cpu().double()
    t0 = time.perf_counter()
    est64 = separate(cpu64, mix)
    cpu_s = time.perf_counter() - t0
    del cpu64
    card_est = stream["est"][key]
    long_snr = snr_db(torch.from_numpy(est64),
                      torch.from_numpy(card_est.astype(np.float64)))
    sisnri = [MetricsTracker()(mix, clean, e, key)["si-snr_i"]
              for e in (est64, card_est)]
    print(f"  longest utterance ({lengths[i_long] / SR:.3f} s): the "
          f"stream's fp32 estimate vs CPU float64 ({cpu_s:.1f} s) SNR "
          f"{long_snr:.2f} dB (limit 60), SI-SNRi {sisnri[1]:.4f} vs "
          f"{sisnri[0]:.4f} dB (limit 0.01)")
    if not (long_snr >= 60.0 and abs(sisnri[0] - sisnri[1]) <= 0.01):
        raise AssertionError("the card disagrees with CPU float64")

    # printed, not claimed
    rtf = {t: audio_s / runs[t]["wall"] for t in runs}
    print(f"  [{card}] eval of {audio_s:.1f} s of audio, wall s (realtime "
          f"factor): " + ", ".join(f"{t} {runs[t]['wall']:.3f} "
                                    f"({rtf[t]:.1f}x)" for t in runs))
    pit_s = split.tracker - split.bss
    print(f"  [{card}] the stream's {stream['wall']:.3f} s: forward on the "
          f"card's clock {fwd_s:.3f} s ({len(split.events)} forwards), "
          f"tracker {split.tracker:.3f} s (BSS-eval {split.bss:.3f}, SI-SNR "
          f"PIT and the rest {pit_s:.3f}), wav writes {split.write:.3f} s, "
          f"wav reads {split.read:.3f} s (reader thread, overlapped)")
    iters_fixed = n * depth
    for t in ("prog_0", "prog_inf", "prog_median"):
        r = runs[t]
        iters = n * DEPTH1 + r["n_hard"] * (depth - DEPTH1)
        print(f"  [{card}] progressive {t}: escalated {r['n_hard']}/{n}, "
              f"utterance-iterations {iters} vs {iters_fixed} at fixed "
              f"depth, batch-iterations {r['launches'] // per_iter} vs "
              f"{depth * len(plan)}, wall {r['wall']:.3f} s vs "
              f"{stream['wall']:.3f} s (si-snr_i avg "
              f"{r['final']['si-snr_i']:.3f} vs "
              f"{stream['final']['si-snr_i']:.3f} dB)")
    launches = sum(r["launches"] for r in runs.values())
    return {"eval_launches": launches, **agree,
            "longest_vs_cpu64_snr_db": long_snr,
            "longest_sisnri_diff_db": abs(sisnri[0] - sisnri[1]),
            "wall_s": {t: r["wall"] for t, r in runs.items()},
            "realtime_factor": rtf, "audio_s": audio_s,
            "stream_split_s": {"forward_card_clock": fwd_s,
                               "tracker": split.tracker, "bss_eval":
                               split.bss, "si_snr_pit_and_rest": pit_s,
                               "wav_write": split.write,
                               "wav_read_overlapped": split.read},
            "escalated": {t: runs[t]["n_hard"] for t in
                          ("prog_0", "prog_inf", "prog_median")},
            "median_delta": median, "cpu64_s": cpu_s}


def write_long(root, seed):
    """The phase's recordings, {name: samples}. Each is up to 0.5 s longer
    than its CSS_SECONDS: the reference's slicer gives back the input's
    length only when its tail ends 1-3.5 s past the last full 3 s hop (a
    tail of 3.5-4 s takes a second padded segment, and the stitch comes
    out short), and both lengths sit inside that range."""
    rng = np.random.default_rng(seed)
    lengths = {}
    for k, seconds in enumerate(CSS_SECONDS):
        T = int(seconds * SR) + int(rng.integers(0, SR // 2))
        s1, s2 = _tones(T, rng)
        name = f"long{k}.wav"
        write_wav(os.path.join(root, name), s1 + s2, SR)
        lengths[name] = T
    return lengths


def _segments_at(model, segs, num_blocks):
    """Segments separated on the card at a fixed depth, as alone, (K,
    n_src, L) numpy."""
    x = torch.from_numpy(np.stack(segs).astype(np.float32)).cuda()
    with torch.inference_mode():
        return np.concatenate([
            model(x[s0:s0 + BATCH], num_blocks=num_blocks,
                  per_utterance=True).cpu().numpy()
            for s0 in range(0, len(x), BATCH)])


def drive_css(card, conf_path, tmp):
    """Phase 19 on the experiment of ``conf_path``: the CSS CLI plain and
    progressive, its streams' lengths, the plain run against float64
    stitching on the CPU, and both runs against stitching of their
    segments separated at fixed depths on the card. Returns the phase's
    record."""
    conf = load_yaml(conf_path)
    model = BaseModel.from_pretrain(os.path.join(
        audio_test.experiment_dir(conf), "best_model.pth")).cuda()
    depth, per_iter = model.num_blocks, sites_per_block(model)
    long_dir = os.path.join(tmp, "long")
    lengths = write_long(long_dir, seed=19)
    audio_s = sum(lengths.values()) / SR
    ds = LibriCSSDataset(long_dir, sample_rate=SR, segment=SEGMENT,
                         overlap=OVERLAP)
    n_segs = {name: len(segs) for name, segs, _ in ds.segments}
    batches = sum(-(-k // BATCH) for k in n_segs.values())
    print(f"recordings {lengths} samples ({audio_s:.1f} s), segments "
          f"{n_segs}")
    checked = eval_sites(model, {
        len(segs[0]): range(1, min(BATCH, max(n_segs.values())) + 1)
        for _, segs, _ in ds.segments})
    check_sites(checked, model.in_channels, "CSS")
    # the progressive run's threshold is the median of stage 1's deltas
    # (an even count: a midpoint), so it escalates a proper subset
    deltas = {name: separate_progressive(
        model, np.stack(segs), depth1=DEPTH1, threshold=np.inf,
        batch_size=BATCH)[1]["delta"] for name, segs, _ in ds.segments}
    threshold = float(np.median(np.concatenate(list(deltas.values()))))
    escalated = {name: d > threshold for name, d in deltas.items()}
    n_esc = {name: int(e.sum()) for name, e in escalated.items()}
    stage2_batches = sum(-(-k // BATCH) for k in n_esc.values())
    runs = {}
    for tag, extra in (("css", []),
                       ("css_prog", ["--progressive_depth", str(DEPTH1),
                                     "--progressive_threshold",
                                     repr(threshold)])):
        out = os.path.join(tmp, tag)
        with recorded_sites() as seen:
            _, wall, launches, _ = run_cli(audio_test_css, [
                "--conf_dir", conf_path, "--test_dir", long_dir,
                "--segment", str(SEGMENT), "--overlap", str(OVERLAP),
                "--save_path", out, *extra], tag)
        expect_checked(seen, checked, tag)
        streams = _read_outputs(out)
        for name, T in lengths.items():
            if streams[name].shape != (2, T) \
                    or not np.isfinite(streams[name]).all():
                raise AssertionError(f"{tag}: {name} gave "
                                     f"{streams[name].shape}, input {T}")
        runs[tag] = dict(wall=wall, launches=launches, streams=streams)
    _expect(runs["css"]["launches"], per_iter * depth * batches,
            "#1 launches of the CSS run")
    _expect(runs["css_prog"]["launches"],
            per_iter * (DEPTH1 * batches + (depth - DEPTH1) * stage2_batches),
            "#1 launches of the progressive CSS run")

    # the first recording against float64 stitching on the CPU; every
    # recording's streams against the stitching of its segments separated
    # again on the card: at full depth for the plain run, and for the
    # progressive run at full depth where a segment escalated, else at
    # depth 8
    overlap_len = int(SR * SEGMENT * OVERLAP)
    cpu64 = copy.deepcopy(model).cpu().double()
    low, swaps_same, cpu_s = math.inf, None, 0.0
    self_low = {"css": math.inf, "css_prog": math.inf}
    for name, segs, pad in ds.segments:
        on_card = separate_segments(model, segs)
        esc = escalated[name][:, None, None]
        fixed = {"css": on_card, "css_prog": np.where(
            esc, on_card, _segments_at(model, segs, DEPTH1))}
        for tag, est in fixed.items():
            mine = stitch_chain(est, overlap_len)
            self_low[tag] = min(self_low[tag], _snr_rows(
                mine[:, :mine.shape[-1] - pad],
                runs[tag]["streams"][name].astype(np.float64)))
        if swaps_same is None:
            # stitching is causal: the first CPU64_SEGMENTS segments give
            # the stream's first samples
            head = segs[:CPU64_SEGMENTS]
            t0 = time.perf_counter()
            ref = separate_segments(cpu64, head)
            cpu_s = time.perf_counter() - t0
            swaps_same = chain_swaps(on_card[:len(head)], overlap_len) \
                == chain_swaps(ref, overlap_len)
            want = stitch_chain(ref, overlap_len)
            low = _snr_rows(want, runs["css"]["streams"][name][
                :, :want.shape[-1]].astype(np.float64))
            print(f"  {name}: the CSS CLI's streams vs float64 stitching on "
                  f"the CPU (the first {len(head)} of {len(segs)} segments, "
                  f"{cpu_s:.1f} s): the same {len(head) - 1} swap decisions "
                  f"{swaps_same}, lowest SNR {low:.2f} dB (limit 60)")
    del cpu64
    print(f"  every recording's streams vs the stitching of its segments "
          f"separated again on the card, lowest SNR: plain "
          f"{self_low['css']:.2f} dB (limit 100), progressive "
          f"{self_low['css_prog']:.2f} dB (limit 60; threshold "
          f"{threshold:.6g}, escalated {n_esc} of {n_segs})")
    if not (swaps_same and low >= 60.0 and self_low["css"] >= 100.0
            and self_low["css_prog"] >= 60.0):
        raise AssertionError("the CSS streams disagree")
    rtf = {t: audio_s / r["wall"] for t, r in runs.items()}
    print(f"  [{card}] CSS of {audio_s:.1f} s: " + ", ".join(
        f"{t} {runs[t]['wall']:.3f} s ({rtf[t]:.1f}x realtime, #1 launches "
        f"{runs[t]['launches']})" for t in runs))
    return {"css_launches": sum(r["launches"] for r in runs.values()),
            "css_vs_cpu64_min_snr_db": low, "css_swaps_same": swaps_same,
            "css_vs_card_segments_min_snr_db": self_low["css"],
            "css_prog_vs_card_segments_min_snr_db": self_low["css_prog"],
            "css_escalated": n_esc,
            "css_wall_s": {t: r["wall"] for t, r in runs.items()},
            "css_realtime_factor": rtf, "css_audio_s": audio_s,
            "css_cpu64_s": cpu_s}


def random_experiment(tmp, seed=0):
    """A recipe model with seeded random weights in an experiment dir, and
    the frozen conf.yml that points at it."""
    from tdanet_tpu_torch.utils.parser import parse_config
    exp = os.path.join(tmp, "exp")
    os.makedirs(exp)
    model = TDANetBest(**RECIPE)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    torch.save(model.serialize(), os.path.join(exp, "best_model.pth"))
    conf = parse_config(["--conf_dir", "configs/tdanet.yml",
                         f"main_args.exp_dir={exp}"])
    conf["audionet"]["audionet_config"] = {
        k: v for k, v in model.get_model_args().items()
        if k != "sample_rate"}
    path = os.path.join(exp, "conf.yml")
    save_yaml(path, conf)
    return path


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
    with tempfile.TemporaryDirectory() as tmp:
        conf = random_experiment(tmp)
        record = {"card": card, **drive_eval(card, conf, tmp),
                  **drive_css(card, conf, tmp)}
    print(json.dumps(record))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
