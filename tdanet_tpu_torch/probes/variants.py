"""Phases 22 and 23 of ``chip_smoke.py``: the TDANet variant family on the
card.

    python -m tdanet_tpu_torch.probes.variants [--out record.json]

Phase 22 (:func:`drive_family`), from #1's launch counts at 0: each of the
eleven classes at the widths of ``configs/tdanet_origin.yml`` (out 128,
in 512, 16 blocks, depth 5, 4 ms encoder, 2 sources) at 16 kHz, seeded
random weights, saved as a reference-format ``.pth`` and read back with
``from_pretrain`` (TDANetMultRes with kernels 4, TDANetChunk with n_chunk
32: 2 s is 1000 samples a chunk). Each model first runs its forward once
with #1 replaced by its plain version, which records the site shapes;
every site not yet held against plain is checked (phase 3's limit); then
``separate`` on a 2 s clip runs the kernel, its sites recorded and all
among those checked, #1's launches exactly 17 x 16 a forward (13 x 16 for
TDANetULayerNum, whose K33 stride-16 pyramid convs are outside #1's
range); the output against the same model on the card with #1's plain
version, >= 60 dB (the classes' CPU float64 forwards, 7-21 s each, are
cut for the time limit of ``chip_smoke.py``; their float64 parity is
held on the CPU against the JAX package by
``tests/test_torch_variants.py``). TDANetYang also runs two rows without
``per_utterance`` (the batch-axis attention across them) against
float64, the inference CLI on its ``.pth``, and one profiled window of
CUDA-graph replays whose #1 device kernels must be 272 a replay.

Phase 23 (:func:`drive_family_training`): ``audio_train`` on
``configs/tdanet_origin.yml`` through the port's parser (TDANetOrigin,
B 8, 3 s segments, bf16, remat "scales", 8 kHz) on
synthetic data, 2 epochs and a resume: a finite history, best_model.pth's
forward equal to the trained model's, #1's forward and backward launches
exact over the run and in one step (544 and 272: every site reaches the
loss, the forward runs again under recomputation); TDANetYang's
gradients at ``GRAD_BLOCKS`` of its 16 blocks (B 2, 1 s, fp32, TF32 off)
against CPU float64, each parameter >= 50 dB, with #1's launches per
step exact under each checkpoint policy, and dropout's masks equal under
recomputation (the float64 step of 16 blocks, 69 s of the CPU, is cut
to 4 for the time limit of ``chip_smoke.py``); then the
times: TDANetYang's forward B 1 2 s fp32, eager and replayed from a CUDA
graph, #1's share of its profiled device time, and the train step at B 8
3 s bf16 of TDANetOrigin with checkpointing and of TDANetYang without
(as audio_train builds each), their peak memory and exact launches. Every
line with a time carries the card's name and power limit. Every #1
launch of the phase is recorded (:func:`card_sites`), and at the end
each site shape is held against plain, forward and backward
(:func:`check_training_sites`): the training segments, the validation
utterances, the gradient check and the timed runs.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tdanet_tpu_torch import models
from tdanet_tpu_torch.kernels import _build
from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_reference)
from tdanet_tpu_torch.models import BaseModel, components
from tdanet_tpu_torch.probes import dw_backward, train_step
from tdanet_tpu_torch.probes.train_step import tone_mix
from tdanet_tpu_torch.probes.eval_path import (
    check_sites, expect_checked, recorded_sites, site_key)
from tdanet_tpu_torch.probes.serve_path import BF16, check_bf16_sites
from tdanet_tpu_torch.utils import read_wav, separate, write_wav
from tdanet_tpu_torch.utils.timing import (
    card_line, counted_windows, cuda_time, graph_time, profiled, snr_db)

SR = 16000
C = 512
# configs/tdanet_origin.yml's widths at 16 kHz
CFG = dict(out_channels=128, in_channels=512, num_blocks=16,
           upsampling_depth=5, enc_kernel_size=4, num_sources=2,
           sample_rate=SR)
# class -> constructor kwargs beyond CFG
FAMILY = {
    "TDANetYang": {}, "TDANetOrigin": {}, "TDANetOld": {}, "TDANet": {},
    "TDANetNoDrop": {}, "TDANetULayerNum": {}, "TDANetGateVariant": {},
    "TDANetChunk": dict(n_chunk=32), "TDANetMultRes": dict(kernels=4),
    "TDANetAttn": {}, "TDANetV2": {}}
# #1's sites a block iteration at depth 5: 5 pyramid convs + 4 expansion
# LAs x 3; TDANetULayerNum's pyramid convs 1-4 (K33 s16) are outside #1
SITES = {name: 13 if name == "TDANetULayerNum" else 17 for name in FAMILY}
SECONDS = 2.0
TRAIN_CONF = "configs/tdanet_origin.yml"
TRAIN_UTTERANCES, VALID_UTTERANCES = 16, 8
PROFILED_REPLAYS = 3
LIMIT_DB, GRAD_LIMIT_DB = 60.0, 50.0
GRAD_BLOCKS = 4  # of 16: the gradient check's depth (the CPU float64 step)
FP32 = "torch.float32"


def _expect(ok, what):
    if not ok:
        raise AssertionError(what)


def build(name, seed, tmp):
    """The class at full width with seeded random weights, through the
    user's path: serialize -> .pth -> from_pretrain -> the card. Returns
    (model, path of the .pth)."""
    model = models.get(name)(**{**_cfg(name), **FAMILY[name]})
    model.reset_parameters(torch.Generator().manual_seed(seed))
    path = os.path.join(tmp, f"{name}.pth")
    torch.save(model.serialize(), path)
    return BaseModel.from_pretrain(path).cuda(), path


def _cfg(name):
    if name == "TDANetChunk":
        return {k: v for k, v in CFG.items() if k != "enc_kernel_size"}
    return CFG


@contextlib.contextmanager
def plain_sites(key=site_key):
    """Inside, the components' #1 calls run #1's plain version and record
    their site keys (``key(x, K, stride, bias, **kw)``): the shapes a run
    will launch #1 at, found without launching it."""
    fn, seen = components.dw_conv_glob_ln, set()

    def plain(x, weight, bias, gamma, beta, *, stride=1, K=5, **kw):
        seen.add(key(x, K, stride, bias is not None, **kw))
        return dw_conv_glob_ln_reference(x, weight, bias, gamma, beta,
                                         stride=stride, K=K, **kw)

    components.dw_conv_glob_ln = plain
    try:
        yield seen
    finally:
        components.dw_conv_glob_ln = fn


@contextlib.contextmanager
def card_sites(key=site_key):
    """Records the site key (``key(x, K, stride, bias, **kw)``) of every #1
    launch on the card inside; the plain-path calls of a float64
    reference on the CPU launch nothing and are not recorded."""
    fn, seen = components.dw_conv_glob_ln, set()

    def record(x, weight, bias, gamma, beta, *, stride=1, K=5, **kw):
        if x.is_cuda:
            seen.add(key(x, K, stride, bias is not None, **kw))
        return fn(x, weight, bias, gamma, beta, stride=stride, K=K, **kw)

    components.dw_conv_glob_ln = record
    try:
        yield seen
    finally:
        components.dw_conv_glob_ln = fn


def check_training_sites(keys, checked, what):
    """#1's forward and backward against their plain versions at every
    site of ``keys`` not in ``checked``, which then holds them: the
    forward at phase 3's limit (fp32: max|d| <= 1e-4 max|ref|; bf16:
    >= 40 dB), the backward as phase 14 holds it (fp32: every gradient's
    max|d| <= 1e-4 of plain's max; bf16: >= 40 dB; a rerun and a graph
    replay bit-equal). A site in a layout or dtype no check covers fails,
    and so does one left outside ``checked``."""
    new = keys - checked
    odd = {k for k in new if not k[5] or k[6] not in (FP32, BF16)}
    _expect(not odd, f"{what}: #1 ran at sites no check covers: "
                     f"{sorted(odd)}")
    fp32 = {k for k in new if k[6] == FP32}
    if fp32:
        check_sites(fp32, C, what)
    if new - fp32:
        check_bf16_sites(new - fp32, C)
    gen = torch.Generator().manual_seed(23)
    t0 = time.perf_counter()
    for B, T, K, stride, bias, _, dtype in sorted(new):
        dw_backward.check_site(B, T, K, stride, bias, gen,
                               torch.float32 if dtype == FP32
                               else torch.bfloat16)
    torch.cuda.synchronize()
    print(f"  #1's backward against plain at the {len(new)} {what} site "
          f"shapes (B {sorted({k[0] for k in new})}, T "
          f"{sorted({k[1] for k in new})}, "
          f"{sorted({k[6] for k in new})}): within the limits, rerun and "
          f"replay bit-equal; {time.perf_counter() - t0:.2f} s wall")
    checked |= new
    expect_checked(keys, checked, what)


class _Sites:
    """The site keys held against plain so far, and #1's launches on the
    main path (checks excluded)."""

    def __init__(self):
        self.checked, self.launches = set(), 0

    def check_then_run(self, fn, what):
        """fn() once on the plain path to find its sites, the new ones held
        against plain, then fn() on the kernel with its sites recorded.
        Returns (kernel output, plain output, #1 launches of the run)."""
        with torch.inference_mode(), plain_sites() as keys:
            plain = fn()
        new = keys - self.checked
        if new:
            check_sites(new, C, what)
            self.checked |= new
        before = dw_conv_glob_ln.launches
        with torch.inference_mode(), recorded_sites() as seen:
            out = fn()
        torch.cuda.synchronize()
        n = dw_conv_glob_ln.launches - before
        self.launches += n
        expect_checked(seen, self.checked, what)
        return out, plain, n


def cpu64_snr(model, wav, got):
    """SNR of the card's ``separate`` output against the same model's in
    float64 on the CPU, and the CPU's seconds."""
    cpu64 = copy.deepcopy(model).cpu().double()
    t0 = time.perf_counter()
    want = separate(cpu64, wav)
    return snr_db(torch.from_numpy(want), torch.from_numpy(got)), \
        time.perf_counter() - t0


def profile_graph(model, wav, replays=PROFILED_REPLAYS, want=None):
    """The forward captured in one CUDA graph, ``replays`` replays under
    the profiler: (#1's device kernels, #1's device ms, all device ms,
    all device kernels, the 12 kernels of most device time as (ms,
    count, name)). With ``want`` (the #1 kernels the window must hold),
    the window is held to it by ``timing.counted_windows``: a short
    window is read once more (the profiler may drop an event, ROADMAP
    C #8), a second short one fails."""
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                model(wav)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            model(wav)
        graph.replay()
        torch.cuda.synchronize()

    def read():
        with torch.inference_mode(), profiled() as prof:
            for _ in range(replays):
                graph.replay()
        got = _window(prof)
        return got[0], want, got
    if want is None:
        return read()[2]
    return counted_windows(read, f"{type(model).__name__} graph replays")


def _window(prof):
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    dev = lambda e: e.self_device_time_total / 1e3  # noqa: E731 (ms)
    dw = [e for e in events if "dw_conv_glob_ln" in e.key]
    return (sum(e.count for e in dw), sum(dev(e) for e in dw),
            sum(dev(e) for e in events), sum(e.count for e in events),
            [(dev(e), e.count, e.key[:90])
             for e in sorted(events, key=dev, reverse=True)[:12]])


def run_inference_cli(path, wav, tmp):
    """``python -m tdanet_tpu_torch.inference`` on the .pth: its two wavs
    (n_src, T) and its wall seconds."""
    mix = os.path.join(tmp, "cli_mix.wav")
    write_wav(mix, wav, SR)
    out = os.path.join(tmp, "cli_sep")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tdanet_tpu_torch.inference", path, mix, out],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    _expect(proc.returncode == 0, f"the inference CLI failed: {proc.stderr}")
    return np.stack([read_wav(f"{out}_s{i}.wav")[0] for i in (1, 2)]), wall


def drive_family(tmp):
    """Phase 22. Returns the record (per class: launches, SNR against
    float64; the B=2 run, the CLI, the profiled replays) and #1's
    main-path launches."""
    sites = _Sites()
    dw_conv_glob_ln.launches = 0
    rec = {}
    for i, name in enumerate(FAMILY):
        t0 = time.perf_counter()
        model, path = build(name, seed=100 + i, tmp=tmp)
        wav = tone_mix(SECONDS, seed=i)
        est, plain, n = sites.check_then_run(
            lambda: separate(model, wav), f"{name} B=1")
        want_n = SITES[name] * CFG["num_blocks"]
        _expect(n == want_n, f"{name}: {n} launches of #1 in one forward, "
                             f"expected {want_n}")
        _expect(est.shape == (2, wav.shape[-1]) and np.isfinite(est).all(),
                f"{name}: bad output {est.shape}")
        row = dict(launches=n, sites=SITES[name],
                   vs_plain_on_card_db=snr_db(torch.from_numpy(plain),
                                              torch.from_numpy(est)))
        against = f"vs the plain path on the card " \
            f"{row['vs_plain_on_card_db']:.2f} dB"
        print(f"{name}: {n} #1 launches ({SITES[name]} x "
              f"{CFG['num_blocks']}); {against} (limit {LIMIT_DB:.0f}); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        _expect(row["vs_plain_on_card_db"] >= LIMIT_DB,
                f"{name} against the plain path {row['vs_plain_on_card_db']}")
        rec[name] = row
        if name == "TDANetYang":
            rec["TDANetYang_B2"] = _yang_extras(model, path, sites, tmp)
        del model
        torch.cuda.empty_cache()
    print(f"phase 22: #1 launched {sites.launches} times on the main path "
          f"(checks excluded), at {len(sites.checked)} site shapes, each "
          f"held against plain first")
    return rec, sites.launches


def _yang_extras(model, path, sites, tmp):
    """TDANetYang at B=2 without per_utterance, the inference CLI, and a
    profiled window of graph replays."""
    two = np.stack([tone_mix(SECONDS, seed=40), tone_mix(SECONDS, seed=41)])
    est, _, n = sites.check_then_run(lambda: separate(model, two),
                                     "TDANetYang B=2")
    _expect(n == SITES["TDANetYang"] * CFG["num_blocks"],
            f"TDANetYang B=2: {n} launches")
    db, cpu_s = cpu64_snr(model, two, est)
    print(f"TDANetYang B=2, the batch-axis attention across the rows: card "
          f"fp32 vs CPU float64 {db:.2f} dB (limit {LIMIT_DB:.0f}; the CPU "
          f"{cpu_s:.1f} s)")
    _expect(db >= LIMIT_DB, f"TDANetYang B=2 disagrees with float64: {db}")
    wav = tone_mix(SECONDS, seed=0)
    cli, wall = run_inference_cli(path, wav, tmp)
    with torch.inference_mode():
        mine = separate(model, wav)
    cli_db = snr_db(torch.from_numpy(mine), torch.from_numpy(cli))
    print(f"inference CLI on TDANetYang's .pth: {cli.shape}, vs separate "
          f"in this process (TF32 off here; the CLI keeps PyTorch's default "
          f"TF32 cuDNN convolutions) {cli_db:.2f} dB (limit "
          f"{LIMIT_DB:.0f}); {wall:.1f} s wall")
    _expect(cli.shape == (2, wav.shape[-1]) and cli_db >= LIMIT_DB,
            "the inference CLI disagrees with separate")
    x = torch.from_numpy(wav).cuda()[None]
    with torch.inference_mode(), plain_sites() as keys:
        model(x)
    new = keys - sites.checked
    if new:
        check_sites(new, C, "TDANetYang graph")
        sites.checked |= new
    want = PROFILED_REPLAYS * SITES["TDANetYang"] * CFG["num_blocks"]
    dw, dw_ms, dev_ms, kernels, _ = profile_graph(model, x, want=want)
    print(f"TDANetYang B=1 {SECONDS} s, {PROFILED_REPLAYS} CUDA-graph "
          f"replays profiled: {dw} dw_conv_glob_ln device kernels (expected "
          f"{want}), {dw_ms:.3f} of {dev_ms:.3f} ms device time "
          f"({100 * dw_ms / dev_ms:.0f}%), {kernels} device kernels")
    _expect(dw == want, f"{dw} #1 device kernels in the window, expected "
                        f"{want}")
    return dict(launches=n, vs_cpu64_db=db, cli_vs_separate_db=cli_db,
                profiled_replays=PROFILED_REPLAYS, profiled_dw_kernels=dw)


def train_origin(tmp, tr, cv):
    """audio_train on configs/tdanet_origin.yml: 2 epochs and a resume
    (``train_step.train_and_resume``), #1's launches exact over the run,
    then one counted step of the resumed trainer. Returns (record, #1's
    (forward, backward) launches over the 2-epoch run)."""
    trainer, resumed, run = train_step.train_and_resume(
        TRAIN_CONF, tr, cv, os.path.join(tmp, "exp_origin"))
    model = trainer.state.model
    _expect(type(model).__name__ == "TDANetOrigin" and model.sm.remat,
            f"trained {type(model).__name__}, remat {model.sm.remat}")
    sites = SITES["TDANetOrigin"] * model.num_blocks
    steps = 2 * len(trainer.datamodule.train_dataloader())
    vals = 2 * len(trainer.datamodule.val_dataloader())
    # a step: the forward, again under recomputation, and one backward a
    # site; a validation batch: one forward. Under the trainer's remat
    # "scales" the inject block's stages between landmarks hold every site
    # (the fusions have none): each is recomputed once, as under full
    # checkpointing, so the count is full checkpointing's
    fwd, bwd = train_step.expected_launches(model.sm.remat, sites, 0,
                                            model.sm.landmarked)
    _expect(model.sm.remat == "scales" and model.sm.landmarked
            and fwd == 2 * sites, "TDANetOrigin should train under the "
            "landmarked remat \"scales\"")
    want = (fwd * steps + sites * vals, bwd * steps)
    print(f"{steps} steps and {vals} validation batches: #1 launches "
          f"{run} (expected {want})")
    _expect(run == want, f"#1 launches {run} over the run, expected {want}")
    mix, src, _ = next(iter(resumed.datamodule.train_dataloader()))
    before = train_step.counts()
    _, loss = resumed.train_step(
        resumed.state, torch.from_numpy(mix).cuda(),
        torch.from_numpy(src).cuda(), torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    one = tuple(a - b for a, b in zip(train_step.counts(), before))
    print(f"one step of the resumed trainer, B={mix.shape[0]}: loss "
          f"{loss.item():.3f}; #1 launches forward {one[0]}, backward "
          f"{one[1]} (expected {(2 * sites, sites)})")
    _expect(one == (2 * sites, sites), f"one step launched #1 {one}")
    return dict(history=trainer.history, resumed=resumed.history,
                run_launches=list(run), step_launches=list(one)), run


def yang_gradients():
    """TDANetYang at the recipe's widths (8 kHz) and ``GRAD_BLOCKS``
    blocks, B=2 1 s fp32: gradients on the card against float64 on the
    CPU (at the card's kinks), #1's launches per step under each
    checkpoint policy (every site reaches the loss), and dropout's masks
    under recomputation (``train_step.check_gradients``).
    Returns the lowest SNR and the launches."""
    model = models.TDANetYang(**dict(train_step.RECIPE,
                                     num_blocks=GRAD_BLOCKS))
    model.reset_parameters(torch.Generator().manual_seed(78))
    return train_step.check_gradients(
        model, SITES["TDANetYang"] * model.num_blocks, seed=5,
        limit_db=GRAD_LIMIT_DB)[:2]


def time_family(card):
    """TDANetYang's forward (B=1, 2 s, fp32) eager and replayed, #1's
    share of the profiled eager forward and of a profiled replay; the
    train step (B=8, 3 s, bf16) of TDANetOrigin with checkpointing and of
    TDANetYang without, as audio_train builds each."""
    from tdanet_tpu_torch.probes import dw_sites
    model = models.TDANetYang(**CFG)
    model.reset_parameters(torch.Generator().manual_seed(1234))
    model = model.cuda().eval()
    wav = torch.from_numpy(tone_mix(SECONDS, seed=9)).cuda()[None]
    with torch.inference_mode():
        ems, eruns, _ = cuda_time(lambda: model(wav), reps=1, runs=9,
                                  warmup=2)
        gms, gruns, _ = graph_time(lambda: model(wav), reps=1, runs=9)
    prof = dw_sites.profile_forward(model, wav)
    dw, dw_ms, dev_ms, _, _ = profile_graph(model, wav, replays=1)
    share = dw_ms / dev_ms if dev_ms > 0 else float("nan")
    print(f"TDANetYang forward B=1 {SECONDS} s fp32: eager median "
          f"{ems:.2f} ms (runs {[round(t, 2) for t in eruns]}), CUDA graph "
          f"replay median {gms:.2f} ms (runs {[round(t, 2) for t in gruns]}"
          f"), {SECONDS / (gms / 1e3):.1f}x realtime [{card}]")
    print(f"  profiled eager forward: {prof['kernels']} device kernels, "
          f"{prof['device_ms']:.3f} ms device time in {prof['wall_ms']:.2f} "
          f"ms wall; #1 {prof['dw_kernels']} kernels {prof['dw_ms']:.3f} ms;"
          f" one profiled replay: #1 {dw} kernels {dw_ms:.3f} of "
          f"{dev_ms:.3f} ms device time ({100 * share:.0f}%) [{card}]")
    for ms, count, key in prof["top"]:
        print(f"    {ms:8.3f} ms {count:5d}x {key}")
    del model
    torch.cuda.empty_cache()
    # medians of 3 steps after 1 (5 after 2 in phase 17): the time limit
    step = train_step.time_steps(8, "scales", steps=3, warmup=1,
                                 model="TDANetOrigin")
    # audio_train builds TDANetYang without checkpointing: its
    # __init__(*args, feat_len, **kwargs) hides remat from the trainer
    yang = train_step.time_steps(8, False, steps=3, warmup=1,
                                 model="TDANetYang")
    for row, recomputed in ((step, 2), (yang, 1)):
        sites = SITES[row["model"]] * CFG["num_blocks"]
        want = (recomputed * sites, sites)
        _expect(tuple(row["launches_per_step"]) == want,
                f"{row['model']}'s step launched #1 "
                f"{row['launches_per_step']} times, expected {want}")
    return dict(yang_forward_eager_ms=ems, yang_forward_graph_ms=gms,
                yang_eager_device_ms=prof["device_ms"],
                yang_eager_kernels=prof["kernels"],
                yang_eager_dw_ms=prof["dw_ms"],
                yang_replay_dw_ms=dw_ms, yang_replay_device_ms=dev_ms,
                yang_replay_dw_share=share,
                origin_step_ms=step["ms"], origin_step_runs=step["runs"],
                origin_step_peak_gib=step["peak_bytes"] / 2 ** 30,
                origin_step_launches=list(step["launches_per_step"]),
                yang_train_step_ms=yang["ms"],
                yang_train_step_runs=yang["runs"],
                yang_train_step_peak_gib=yang["peak_bytes"] / 2 ** 30,
                yang_train_step_launches=list(yang["launches_per_step"]),
                card=card)


def drive_family_training(card, tmp, data=None):
    """Phase 23; ``data`` is (train dir, valid dir) of phase 16, else
    written here. Returns the record and #1's (forward, backward)
    launches of the audio_train run."""
    if data is None:
        data = (os.path.join(tmp, "tr"), os.path.join(tmp, "cv"))
        train_step.write_split(data[0], TRAIN_UTTERANCES, seed=0)
        train_step.write_split(data[1], VALID_UTTERANCES, seed=1)
    with card_sites() as seen:
        rec, run = train_origin(tmp, *data)
        rec["yang_grad_min_snr_db"], launches = yang_gradients()
        rec["yang_step_launches"] = {str(k): list(v)
                                     for k, v in launches.items()}
        rec["times"] = time_family(card)
    check_training_sites(seen, set(), "phase 23")
    rec["site_shapes"] = len(seen)
    return rec, run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
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
    with tempfile.TemporaryDirectory() as tmp:
        print("== 22 TDANet variant family (launch counts from 0)")
        family, launches = drive_family(tmp)
        print(f"== 23 the family's training on the card (card: {card})")
        training, run = drive_family_training(card, tmp)
    record = dict(card=card, family=family, variant_launches=launches,
                  training=training, variant_train_launches=list(run))
    print(json.dumps(record))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    sys.exit(main() and 0)
