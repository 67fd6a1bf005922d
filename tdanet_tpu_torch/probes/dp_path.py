"""Data parallelism on the card: ``chip_smoke.py`` phase 27, and the same
phase alone.

    python -m tdanet_tpu_torch.probes.dp_path [--out record.json]

The model is the recipe at full width (``probes/train_step.py`` RECIPE:
TDANetBest out 128, in 512, 16 blocks, depth 5, 4 ms, 2 sources, 8 kHz),
seeded random weights, fp32 with TF32 off unless a part says otherwise:

(a) NCCL at world 1 in this process: one train step under the process
    mesh against one without (B=4, 1 s, dropout on, the same generator
    seeds), every gradient as the clip sees it >= 100 dB;
(b) two ranks on the one card over gloo (NCCL refuses two ranks on one
    device), started by ``launch_multihost``: global B=4 (2 a rank), the
    same rows and seeds as (a). The loss equal on both ranks, every
    parameter after the step equal bit for bit on both, #1's launches per
    rank per step exactly 512 forward and 464 backward (no
    checkpointing); every gradient against (a)'s one-process step >= 90
    dB as it stands, and >= 100 dB with every activation's side pinned to
    that step's (each rank its rows of ``train_step.Kinks``' recording:
    fp32 puts a few PReLU inputs of the 2-row arithmetic on the other side
    of their kink). Two broken controls run the same step and must fall
    below both limits: the gather of the batch-axis attention made the
    identity (each rank attends over its own rows), and the masks drawn
    over each rank's own rows, as a DistributedDataParallel wrap would.
    Each rank's step ms beside the one-process step's;
(c) ``launch_multihost --nprocs 2`` running ``audio_train`` on
    configs/tdanet.yml (bf16, remat "scales", global B=8) over phase 16's
    16 + 8 synthetic utterances, one epoch: both ranks' history rows
    equal (the trainer checks it), #1's launches on each rank exactly
    ``train_step.expected_launches`` a step (928 forward, 464 backward)
    and 512 a validation batch, one best_model.pth, whose forward on the
    card equals rank 0's best checkpoint's within 1e-6 of max abs;
(d) ``audio_test --dp 2`` on phase 18's corpus over a mesh of
    [cuda:0, cuda:0] against ``--dp 1``: every metric of metrics.csv
    within 0.01 dB, #1's launches exactly twice (each batch of 8 is two
    forwards of 4); ``AsyncBatchServer(mesh=...)`` on 12 requests of
    1-4 s against the server without a mesh, >= 60 dB each, #1's wrapper
    launches exactly 2 x 512 a captured graph.

Before the counted runs, #1 forward (fp32, and bf16 for (c)) and its
backward are held against their plain versions at every site shape the
phase gives them; the in-process runs record their sites, and a site
outside the checked set fails the phase.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from tdanet_tpu_torch import audio_test
from tdanet_tpu_torch.kernels import _build
from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_backward)
from tdanet_tpu_torch.launch_multihost import free_port
from tdanet_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
from tdanet_tpu_torch.models import BaseModel, TDANetBest
from tdanet_tpu_torch.parallel import make_mesh
from tdanet_tpu_torch.probes import dw_backward, eval_path, serve_path
from tdanet_tpu_torch.probes.dw_sites import block_sites
from tdanet_tpu_torch.probes.train_step import (
    RECIPE, Kinks, expected_launches, tone_batch, tone_mix, write_split)
from tdanet_tpu_torch.system.optimizers import make_optimizer
from tdanet_tpu_torch.system.trainer import (create_train_state,
                                             make_train_step)
from tdanet_tpu_torch.utils.timing import card_line, snr_db

SR = RECIPE["sample_rate"]
B, SECONDS = 4, 1.0           # (a) and (b): the global batch
WEIGHTS, DATA, MASKS = 27, 3, 5  # seeds
TIMED_STEPS = 3
GRAD_LIMIT_DB, SERVE_LIMIT_DB, METRIC_LIMIT_DB = 100.0, 60.0, 0.01
# (b) as it stands, activation sides unpinned: below the 99.6 dB that the
# sound path reads (3 and 1 elements across a kink), far above the broken
# controls (PERF.md section 2)
UNPINNED_LIMIT_DB = 90.0
SITES_PER_BLOCK = 32          # #1 sites a block iteration at depth 5
DEAD_SITES = 3                # the coarsest LA fusion: no backward
REQUESTS = [1.0, 2.5, 4.0, 1.5, 3.0, 2.0, 3.5, 1.2, 2.8, 4.0, 1.8, 3.3]
BUCKETS = [int(s * SR) for s in (1, 2, 3, 4)]
MESH_DEVICES = ["cuda:0", "cuda:0"]


def _expect(ok, what):
    if not ok:
        raise AssertionError(what)


def counts():
    return dw_conv_glob_ln.launches, dw_conv_glob_ln_backward.launches


def zero_counts():
    torch.cuda.synchronize()
    dw_conv_glob_ln.launches = dw_conv_glob_ln_backward.launches = 0


def step_once(mesh, mix, src, timed=TIMED_STEPS, kinks=None):
    """One train step of the seeded recipe model on this process's rows
    (under ``mesh`` if given), from #1's launch counts at 0; under
    ``kinks()`` when given (``train_step.Kinks``: recording every
    activation's side, or imposing a recording). Returns its loss, its
    gradients as the clip sees them and the parameters after the update
    (on the CPU), the launches, and the median ms of ``timed`` further
    steps (host clock around synchronised steps; None when 0)."""
    model = TDANetBest(**RECIPE)
    tx = make_optimizer("adam", lr=2e-3, grad_clip=5.0)
    state = create_train_state(model, tx,
                               torch.Generator().manual_seed(WEIGHTS),
                               mesh=mesh, device=None if mesh else "cuda")
    step = make_train_step(model, PITLossWrapper(
        pairwise_neg_snr, threshold_byloss=True), tx, mesh=mesh)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads, clip = {}, tx.clip_

    def record(gs):
        if not grads:
            grads.update({n: g.detach().cpu().clone()
                          for (n, _), g in zip(named, gs)})
        return clip(gs)
    tx.clip_ = record
    zero_counts()
    with kinks() if kinks is not None else contextlib.nullcontext():
        state, loss = step(state, mix, src,
                           torch.Generator().manual_seed(MASKS))
    loss = loss.item()
    launches = counts()
    params = {n: p.detach().cpu().clone() for n, p in named}
    times = []
    for i in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, mix, src,
                        torch.Generator().manual_seed(MASKS + 1 + i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"loss": loss, "grads": grads, "params": params,
            "launches": launches, "runs_ms": times,
            "ms": statistics.median(times) if times else None}


def grad_floor(ref, got, what, limit=GRAD_LIMIT_DB):
    """The lowest gradient SNR of ``got`` against ``ref`` (an unreached
    parameter's zero gradient must be zero on both sides), held to
    ``limit`` (None: printed only)."""
    snrs = {}
    for n, r in ref.items():
        g = got[n]
        if not torch.count_nonzero(r):
            _expect(not torch.count_nonzero(g), f"{what}: {n} should get a "
                                                f"zero gradient")
            continue
        snrs[n] = snr_db(r, g)
    low = sorted(snrs.items(), key=lambda kv: kv[1])
    print(f"  {what}: lowest gradient SNR {low[0][1]:.2f} dB ("
          + (f"limit {limit:g}" if limit is not None else "not held")
          + f"), median {statistics.median(snrs.values()):.2f} dB; lowest "
          "five: " + ", ".join(f"{n} {v:.2f}" for n, v in low[:5]))
    _expect(limit is None or low[0][1] >= limit,
            f"{what}: gradients disagree")
    return low[0][1]


def expect_step_launches(got, what):
    want = (SITES_PER_BLOCK * RECIPE["num_blocks"],
            (SITES_PER_BLOCK - DEAD_SITES) * RECIPE["num_blocks"])
    print(f"  {what}: #1 launches forward {got[0]}, backward {got[1]} "
          f"(expected {want}, no checkpointing)")
    _expect(tuple(got) == want, f"{what}: #1 launches {got}, expected "
                                f"{want}")


# -- (a) ----------------------------------------------------------------------

def drive_nccl_world1(mix, src, reference):
    """(a): the step under an NCCL process group of one rank in this
    process against ``reference``, the one-process step."""
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        _expect(mesh.dp == 1 and mesh.device == torch.device("cuda:0"),
                f"NCCL world-1 mesh {mesh}")
        got = step_once(mesh, mix, src)
    finally:
        dist.destroy_process_group()
    print(f"  (a) NCCL world 1: loss {got['loss']!r} (one process "
          f"{reference['loss']!r}); step {got['ms']:.1f} ms (one process "
          f"{reference['ms']:.1f})")
    expect_step_launches(got["launches"], "(a)")
    low = grad_floor(reference["grads"], got["grads"], "(a) mesh vs none",
                     GRAD_LIMIT_DB)
    return {"loss": got["loss"], "min_grad_snr_db": low, "ms": got["ms"],
            "launches": list(got["launches"])}


# -- (b) ----------------------------------------------------------------------

def launch(tag, nprocs, cmd, timeout, cwd):
    """``launch_multihost`` with every rank on cuda:0 over gloo; returns
    its stdout (raises with both streams on a non-zero exit)."""
    argv = [sys.executable, "-m", "tdanet_tpu_torch.launch_multihost",
            "--nprocs", str(nprocs), "--device", "cuda:0", "--backend",
            "gloo", "--timeout", str(timeout), "--", *cmd]
    t0 = time.perf_counter()
    out = subprocess.run(argv, cwd=cwd, capture_output=True, text=True,
                         timeout=timeout + 60)
    print(f"  {tag}: launch_multihost --nprocs {nprocs} exit "
          f"{out.returncode} in {time.perf_counter() - t0:.1f} s")
    if out.returncode != 0:
        raise AssertionError(f"{tag} failed:\n{out.stdout[-4000:]}\n"
                             f"{out.stderr[-4000:]}")
    return out.stdout


@contextlib.contextmanager
def broken(control):
    """The data-parallel path broken as a control: ``"no gather"``, the
    batch-axis attention over the rank's own rows; ``"rank masks"``, every
    dropout mask drawn over the rank's own rows from the same seed."""
    from tdanet_tpu_torch.parallel import collectives
    saved = dict(vars(collectives))
    if control == "no gather":
        collectives.gather_rows = lambda x, group: x
    else:
        collectives.global_shape = lambda shape, group, axis=0: tuple(shape)
        collectives.rank_rows = lambda t, group, axis=0: t
    try:
        yield
    finally:
        for name in ("gather_rows", "global_shape", "rank_rows"):
            setattr(collectives, name, saved[name])


CONTROLS = ("no gather", "rank masks")


def rank_step(out_prefix, device):
    """(b)'s rank: join the group, run the step on this rank's rows of the
    global batch, then again with every activation's side pinned to the
    one-process step's (its rows of ``<out_prefix>kinks.pt``), then each
    broken control unpinned and pinned; save them all."""
    from tdanet_tpu_torch.parallel import initialize_distributed
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _expect(initialize_distributed(device=device), "no process group")
    mesh = make_mesh(devices=[device])
    mix, src = tone_batch(B, seconds=SECONDS, seed=DATA)
    n = B // mesh.dp
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    mix, src = mix[rows].contiguous(), src[rows].contiguous()
    got = step_once(mesh, mix, src)
    masks = [tuple(m[rows] for m in call) for call in
             torch.load(f"{out_prefix}kinks.pt", weights_only=True)]
    kinks = Kinks(masks)
    pinned = step_once(mesh, mix, src, timed=0, kinks=kinks)
    _expect(kinks.calls == len(masks), "the rank passed fewer activation "
                                       "kinks than the one-process step")
    got.update(pinned_grads=pinned["grads"], pinned_loss=pinned["loss"],
               flips=kinks.flips, controls={})
    for control in CONTROLS:
        with broken(control):
            plain = step_once(mesh, mix, src, timed=0)
            held = step_once(mesh, mix, src, timed=0, kinks=Kinks(masks))
        got["controls"][control] = (plain["grads"], held["grads"])
    torch.save(got, f"{out_prefix}{mesh.rank}.pt")
    print(f"RANK {mesh.rank} LOSS {got['loss']!r} LAUNCHES "
          f"{got['launches'][0]} {got['launches'][1]} MS {got['ms']:.2f} "
          f"FLIPS {kinks.flips}", flush=True)
    dist.destroy_process_group()


def drive_two_ranks(tmp, reference, pinned):
    """(b): two ranks on cuda:0 over gloo against ``reference``, the
    one-process step; ``pinned`` is that step again with its activation
    sides recorded (``train_step.Kinks``), which the ranks impose on a
    second step of theirs. fp32 puts a few PReLU inputs of the 2-row and
    the 4-row arithmetic on opposite sides of the kink, and each such
    element moves every gradient upstream of it (PERF.md §6): the step as
    it stands is held to UNPINNED_LIMIT_DB, the pinned one to
    GRAD_LIMIT_DB, and each broken control must fall below both."""
    prefix = os.path.join(tmp, "dp_rank")
    torch.save(pinned["kinks"].masks, f"{prefix}kinks.pt")
    launch("(b)", 2, ["-m", "tdanet_tpu_torch.probes.dp_path", "--rank-step",
                      prefix], 300, os.getcwd())
    ranks = [torch.load(f"{prefix}{r}.pt", weights_only=False)
             for r in (0, 1)]
    for key in ("loss", "pinned_loss"):
        _expect(ranks[0][key] == ranks[1][key],
                f"(b) {key} differs: {ranks[0][key]!r} {ranks[1][key]!r}")
    same = all(torch.equal(ranks[0]["params"][n], ranks[1]["params"][n])
               for n in ranks[0]["params"])
    print(f"  (b) loss {ranks[0]['loss']!r} on both ranks (one process "
          f"{reference['loss']!r}); parameters after the step equal bit for "
          f"bit on the two ranks: {same}")
    _expect(same, "(b) the ranks' parameters differ")
    lows, plain, controls = [], [], {c: [] for c in CONTROLS}
    for r, got in enumerate(ranks):
        expect_step_launches(got["launches"], f"(b) rank {r}")
        plain.append(grad_floor(reference["grads"], got["grads"],
                                f"(b) rank {r} vs one process",
                                UNPINNED_LIMIT_DB))
        print(f"  (b) rank {r}: {got['flips']} activation inputs lie on the "
              f"other side of their kink than in the one-process step")
        lows.append(grad_floor(pinned["grads"], got["pinned_grads"],
                               f"(b) rank {r} vs one process, kinks pinned",
                               GRAD_LIMIT_DB))
        for control in CONTROLS:
            bad, bad_pinned = got["controls"][control]
            pair = (grad_floor(reference["grads"], bad,
                               f"(b) rank {r} control '{control}'", None),
                    grad_floor(pinned["grads"], bad_pinned,
                               f"(b) rank {r} control '{control}', kinks "
                               f"pinned", None))
            _expect(pair[0] < UNPINNED_LIMIT_DB and pair[1] < GRAD_LIMIT_DB,
                    f"(b) the control '{control}' passes the gradient "
                    f"checks: {pair}")
            controls[control].append(pair)
    ms = [got["ms"] for got in ranks]
    print(f"  (b) step ms per rank {[round(v, 1) for v in ms]} (runs "
          f"{[[round(t, 1) for t in g['runs_ms']] for g in ranks]}), one "
          f"process over the 4 rows {reference['ms']:.1f} ms")
    return {"loss": ranks[0]["loss"], "min_grad_snr_db": min(lows),
            "min_grad_snr_db_unpinned": min(plain),
            "controls_min_grad_snr_db": {
                c: [min(p[0] for p in v), min(p[1] for p in v)]
                for c, v in controls.items()},
            "kink_flips": [g["flips"] for g in ranks],
            "launches_per_rank": [list(g["launches"]) for g in ranks],
            "ms_per_rank": ms, "one_process_ms": reference["ms"],
            "params_equal": same}


# -- (c) ----------------------------------------------------------------------

def rank_train(argv):
    """(c)'s rank: ``audio_train`` as the CLI runs it, then this rank's
    #1 launches over the run."""
    from tdanet_tpu_torch import audio_train
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ.get("RANK", "0"))
    t0 = time.perf_counter()
    audio_train.cli(argv)
    torch.cuda.synchronize()
    f, b = counts()
    print(f"RANK {rank} DW_LAUNCHES {f} {b} TRAIN_S "
          f"{time.perf_counter() - t0:.2f}", flush=True)


def _utterances(split):
    with open(os.path.join(split, "mix_clean.json")) as f:
        return len(json.load(f))


def drive_train(tmp, data):
    tr, cv = data
    exp = os.path.join(tmp, "dp_exp")
    out = launch("(c)", 2, [
        "-m", "tdanet_tpu_torch.probes.dp_path", "--rank-train",
        "--conf_dir", "configs/tdanet.yml",
        f"datamodule.data_config.train_dir={tr}",
        f"datamodule.data_config.valid_dir={cv}",
        f"datamodule.data_config.test_dir={cv}",
        "datamodule.data_config.num_workers=2", "training.epochs=1",
        f"main_args.exp_dir={exp}", "exp.disable_wandb=true"], 400,
        os.getcwd())
    for line in out.splitlines():
        if line.startswith("{") or "ranks" in line or "RANK" in line:
            print(f"    {line}")
    _expect("history rows equal on 2 ranks" in out,
            "(c) the trainer did not find the ranks' histories equal")
    _expect(out.count("Exported best_model.pth") == 1,
            "(c) best_model.pth was not exported exactly once")
    launches = {int(m.group(1)): (int(m.group(2)), int(m.group(3)))
                for m in re.finditer(r"RANK (\d) DW_LAUNCHES (\d+) (\d+)",
                                     out)}
    # every rank loads the global batch of 8: its steps and validation
    # batches are the splits' utterances // 8, whatever its rows
    steps, vals = (_utterances(d) // 8 for d in (tr, cv))
    sites = SITES_PER_BLOCK * RECIPE["num_blocks"]
    fwd, bwd = expected_launches("scales", sites,
                                 DEAD_SITES * RECIPE["num_blocks"])
    want = (steps * fwd + vals * sites, steps * bwd)
    _expect(sorted(launches) == [0, 1] and launches[0] == launches[1]
            == want, f"(c) #1 launches {launches}, expected {want} a rank")
    with open(os.path.join(exp, "history.json")) as f:
        hist = json.load(f)
    _expect(len(hist) == 1 and all(np.isfinite(v) for v in hist[0].values()),
            f"(c) history {hist}")
    # best_model.pth against rank 0's best checkpoint, on the card
    with open(os.path.join(exp, "best_k_models.json")) as f:
        best_step = json.load(f)["best_step"]
    ckpt = torch.load(os.path.join(exp, "best", f"{best_step}.pt"),
                      map_location="cuda", weights_only=True)
    trained = TDANetBest(**RECIPE).cuda()
    trained.load_state_dict(ckpt["model"])
    exported = BaseModel.from_pretrain(
        os.path.join(exp, "best_model.pth")).cuda()
    x = torch.from_numpy(tone_mix(2.0, seed=27, sr=SR)).cuda()[None]
    with torch.inference_mode():
        want, got = trained(x), exported(x)
    err = (got - want).abs().max().item()
    lim = 1e-6 * want.abs().max().item()
    print(f"  (c) history {hist[0]}; best_model.pth (step {best_step}) "
          f"against rank 0's checkpoint: max|d| {err:.3e} (limit "
          f"{lim:.3e}); #1 launches per rank {launches[0]} (expected "
          f"{want})")
    _expect(err <= lim, "(c) best_model.pth differs from the trained model")
    return {"history": hist[0], "export_max_abs_err": err,
            "launches_per_rank": [list(launches[r]) for r in (0, 1)]}, \
        os.path.join(exp, "conf.yml")


# -- (d) ----------------------------------------------------------------------

def _metrics(exp):
    with open(os.path.join(exp, "results", "metrics.csv")) as f:
        return list(csv.DictReader(f))


def drive_eval(tmp, conf):
    """(d): audio_test --dp 2 on phase 18's corpus against --dp 1."""
    model = BaseModel.from_pretrain(os.path.join(
        audio_test.experiment_dir(eval_path.load_yaml(conf)),
        "best_model.pth")).cuda()
    eval_conf, _, lengths = eval_path.eval_corpus(conf, model.lcm, tmp)
    exp = audio_test.experiment_dir(eval_path.load_yaml(eval_conf))
    argv = ["--conf_dir", eval_conf, "--device", "cuda:0", "--batch_size",
            str(eval_path.BATCH)]
    runs = {}
    for dp in (1, 2):
        with eval_path.recorded_sites() as seen:
            _, wall, launches, final = eval_path.run_cli(
                audio_test, argv + ["--dp", str(dp)], f"(d) --dp {dp}")
        _expect(audio_test.ok(final), f"(d) --dp {dp}: {final}")
        runs[dp] = (_metrics(exp), wall, launches, set(seen))
    (m1, w1, l1, _), (m2, w2, l2, seen2) = runs[1], runs[2]
    _expect([r["snt_id"] for r in m1] == [r["snt_id"] for r in m2]
            and len(m1) == len(lengths) + 2, "(d) metrics.csv rows differ")
    worst = max(abs(float(a[k]) - float(b[k])) for a, b in zip(m1, m2)
                for k in a if k != "snt_id")
    print(f"  (d) --dp 2 against --dp 1: every metric within {worst:.2e} "
          f"dB (limit {METRIC_LIMIT_DB}); #1 launches {l2} against {l1} "
          f"(twice: each batch of {eval_path.BATCH} is two forwards)")
    _expect(worst <= METRIC_LIMIT_DB, "(d) metrics differ")
    _expect(l2 == 2 * l1, f"(d) #1 launches {l2}, expected {2 * l1}")
    return {"metric_max_diff_db": worst, "launches": [l1, l2],
            "wall_s": [w1, w2]}, model, seen2


def drive_server(model):
    """(d): AsyncBatchServer over a mesh of two replicas on the card
    against the server without a mesh, the same 12 requests."""
    from tdanet_tpu_torch.serving import AsyncBatchServer
    model = model.eval()
    wavs = [tone_mix(s, seed=270 + i, sr=SR) for i, s in enumerate(REQUESTS)]
    answers, launches, graphs = {}, {}, {}
    seen = set()
    for tag, mesh in (("none", None), ("mesh", make_mesh(
            devices=MESH_DEVICES))):
        zero_counts()
        ctx = eval_path.recorded_sites() if mesh is not None else \
            contextlib.nullcontext(set())
        with ctx as rec:
            server = AsyncBatchServer(model, max_batch=4,
                                      length_buckets=BUCKETS, mesh=mesh)
            try:
                futures = [server.submit(w) for w in wavs]
                answers[tag] = [f.result(timeout=300) for f in futures]
            finally:
                server.close()
        seen |= rec
        torch.cuda.synchronize()
        launches[tag], graphs[tag] = dw_conv_glob_ln.launches, \
            server.stats["graphs"]
    low = min(snr_db(torch.from_numpy(b), torch.from_numpy(a))
              for a, b in zip(answers["mesh"], answers["none"]))
    want = 2 * SITES_PER_BLOCK * RECIPE["num_blocks"] * graphs["mesh"]
    print(f"  (d) AsyncBatchServer over [cuda:0, cuda:0] against no mesh, "
          f"{len(wavs)} requests of 1-4 s: lowest SNR {low:.2f} dB (limit "
          f"{SERVE_LIMIT_DB:g}); graphs {graphs['mesh']} (without a mesh "
          f"{graphs['none']}); #1 launches {launches['mesh']} (expected "
          f"{want}: a set-up forward and a capture a graph)")
    _expect(low >= SERVE_LIMIT_DB, "(d) the mesh server disagrees")
    _expect(graphs["mesh"] == 2 * graphs["none"],
            "(d) not one graph a replica and bucket")
    _expect(launches["mesh"] == want, "(d) the mesh server's #1 launches")
    return {"min_snr_db": low, "graphs": graphs["mesh"],
            "launches": launches["mesh"]}, seen


# -- the phase ----------------------------------------------------------------

def phase_sites(model, corpus_lengths):
    """Every site key the phase gives #1: the steps' B=4 and B=2 at 1 s
    (fp32), (c)'s B=4 at 3 s (bf16), the eval's replicas at B=4 and the
    server's at B=2 (fp32)."""
    f32, bf16 = "torch.float32", "torch.bfloat16"
    lattice = model.lcm
    combos = [(int(SECONDS * SR), 4, f32), (int(SECONDS * SR), 2, f32),
              (3 * SR, 4, bf16)]
    combos += [(-(-n // lattice) * lattice, 4, f32)
               for n in set(corpus_lengths)]
    combos += [(-(-n // lattice) * lattice, 2, f32) for n in BUCKETS]
    return serve_path.serve_sites(model, combos)


def check_phase_sites(model, keys):
    """#1 forward at every key, and its backward at the training keys,
    against plain before the counted runs."""
    f32 = {k for k in keys if k[-1] == "torch.float32"}
    bf16 = {k for k in keys if k[-1] == "torch.bfloat16"}
    eval_path.check_sites(f32, model.in_channels, "phase-27 fp32")
    serve_path.check_bf16_sites(bf16, model.in_channels)
    gen = torch.Generator().manual_seed(270)
    worst, low = 0.0, float("inf")
    train = {(k[0], k[1], k[2], k[3], k[4], k[-1]) for k in keys
             if k[0] in (2, 4) and (k[-1] == "torch.bfloat16"
                                    or k[1] in _step_lengths(model))}
    for Bk, T, K, stride, bias, dtype in sorted(train):
        got, _ = dw_backward.check_site(Bk, T, K, stride, bias, gen,
                                        getattr(torch, dtype.split(".")[1]))
        vals = list(got.values())
        if dtype == "torch.float32":
            worst = max(worst, max(vals))
        else:
            low = min(low, min(vals))
    print(f"  #1's backward against plain at the {len(train)} training "
          f"site shapes: fp32 worst {worst:.2e} of max abs, bf16 lowest "
          f"{low:.1f} dB")


def _step_lengths(model):
    with torch.inference_mode():
        T0 = model._front(torch.zeros(1, int(SECONDS * SR),
                                      device="cuda"))[0].shape[-1]
    return {T for T, _, _, _ in block_sites(T0, model.upsampling_depth)}


def one_process_steps(mix, src):
    """The one-process step over the global batch, twice: timed (the
    reference of (a) and (b)), and with every activation's side recorded
    (``pinned["kinks"]``, the reference of (b)'s pinned comparison)."""
    reference = step_once(None, mix, src)
    expect_step_launches(reference["launches"], "one process")
    pinned = {"kinks": Kinks()}
    pinned.update(step_once(None, mix, src, timed=0, kinks=pinned["kinks"]))
    return reference, pinned


def drive_dp(card, tmp, data=None):
    """Phase 27. ``data``: (train dir, valid dir) of phase 16's synthetic
    utterances (written here when None). Returns the phase's record."""
    t_start = time.perf_counter()
    tmp = os.path.join(tmp, "dp")
    os.makedirs(tmp)
    if data is None:
        data = (os.path.join(tmp, "tr"), os.path.join(tmp, "cv"))
        write_split(data[0], 16, seed=0)
        write_split(data[1], 8, seed=1)
    probe = TDANetBest(**RECIPE).cuda()
    corpus = eval_path.corpus_lengths(probe.lcm, seed=18)
    keys = phase_sites(probe, corpus)
    check_phase_sites(probe, keys)
    del probe

    mix, src = tone_batch(B, seconds=SECONDS, seed=DATA)
    with eval_path.recorded_sites() as seen:
        reference, pinned = one_process_steps(mix, src)
        a = drive_nccl_world1(mix, src, reference)
    b = drive_two_ranks(tmp, reference, pinned)
    c, conf = drive_train(tmp, data)
    d, model, seen_eval = drive_eval(tmp, conf)
    serve, seen_serve = drive_server(model)
    eval_path.expect_checked(set(seen) | seen_eval | seen_serve, keys,
                             "phase 27")
    del model
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    print(f"phase 27: {seconds:.1f} s (card: {card})")
    return {"card": card, "seconds": seconds, "nccl_world1": a,
            "two_ranks_gloo": b, "audio_train": c, "audio_test": d,
            "serve": serve,
            "dw_launches": {"step_per_rank": b["launches_per_rank"][0][0],
                            "nccl_world1_step": a["launches"][0],
                            "audio_train_per_rank":
                                c["launches_per_rank"][0][0],
                            "audio_test_dp2": d["launches"][1],
                            "serve_mesh": serve["launches"]},
            "backward_launches": {
                "step_per_rank": b["launches_per_rank"][0][1],
                "nccl_world1_step": a["launches"][1],
                "audio_train_per_rank": c["launches_per_rank"][0][1]}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the record as JSON")
    ap.add_argument("--rank-step", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank-train", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda:0", help=argparse.SUPPRESS)
    args, rest = ap.parse_known_args(argv)
    if args.rank_step:
        return rank_step(args.rank_step, args.device)
    if args.rank_train:
        return rank_train(rest + ["--device", args.device])
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # the phase's two sources at once
        list(pool.map(_build.build, ("dw_conv_glob_ln",
                                     "dw_conv_glob_ln_backward")))
    print(f"built #1 and its backward in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        record = drive_dp(card, tmp)
    print(json.dumps({k: v for k, v in record.items()}))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
