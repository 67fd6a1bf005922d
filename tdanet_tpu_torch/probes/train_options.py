"""Training as every JAX config can ask for it, on the card:
``chip_smoke.py`` phase 29, and the same phase alone.

    python -m tdanet_tpu_torch.probes.train_options [--out record.json]

(a) every optimizer name of the factory (the JAX package's 32): the
    gradients of one backward of the recipe's model at full width (out
    128, in 512, 16 blocks, depth 5, seeded weights, B=2 1 s fp32); from
    the same parameters, 3 steps with gradients g, -0.5 g and a seeded
    permutation of g's elements (each tensor its own), the learning rate
    halved before step 3, the global-norm clip at 5; the same on the CPU
    in float64 with the same code. The card's parameter change against
    float64's: an SNR within ``FLOOR_MARGIN_DB`` of the floor that keeping
    the parameters in fp32 sets for each name. Lion's step is a
    sign: an element whose interpolated update lies within rounding of 0
    may take the other sign on the card and move by 2 lr; those flips are
    counted (an element off by more than lr / 2), bounded by
    ``FLIP_SHARE_LIMIT`` of the elements, and the SNR is taken over the
    rest;
(b) each name's ``step()`` on those 2.34 M parameters in 136 tensors: ms,
    the median of 5 after 2, host clock around a synchronised step, and
    its device kernels in one profiled step (``timing.counted_windows``,
    the step bracketed by #1 launches whose count the window must hold);
    ``adam`` is torch's own foreach Adam;
(c) ``audio_train`` on phase 16's corpus (configs/tdanet.yml, bf16, remat
    "scales") with ``optimizer.optim_name=adafactor`` for one epoch, then
    ``main_args.resume=true`` for one more: the optimizer state the
    resumed trainer loads equals the saved one bit for bit, the losses
    are finite, and #1's launches are phase 16's a step and a validation
    batch;
(d) one train step of TDANetBest with ``num_sources=6`` at 4 blocks (the
    recipe's widths), B=2 1 s fp32, PIT neg-SNR through scipy's Hungarian
    assignment on the host: the assignments equal the CPU float64 step's,
    the loss within ``LOSS_DB_LIMIT`` dB and every gradient >= 50 dB (phase
    15's limit; both taken at the card's side of every activation kink,
    ``train_step.Kinks``); the step's ms (``train_step.time_steps``:
    Adam, clip 5, median of 5 after 2);
(e) a small audio-visual split written on the card's host (stored and
    deflated float32 archives, a stored uint8 one): every native AV batch
    equals the dataset's items (the frames the item has, zeros past them)
    and the loader's plain draws bit for bit, and a garbled archive
    raises with its path.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_backward)
from tdanet_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
from tdanet_tpu_torch.models import TDANetBest
from tdanet_tpu_torch.probes import train_step
from tdanet_tpu_torch.system import optimizers as topt
from tdanet_tpu_torch.utils.timing import (card_line, counted_windows,
                                           device_kernels, profiled, snr_db)

NAMES = sorted(topt._FACTORIES)
LR, CLIP = 2e-3, 5.0
# The limit, stated before the first run on the card. The card keeps the
# parameters in fp32, so each of the 3 steps rounds every element that
# moves to fp32 where float64 does not: an error of variance ulp(p)^2 / 12
# a step. That sets a floor on the SNR of the change for each rule,
# ``rounding_floor_db``: 10 log10(|dp|^2 / (3 sum ulp^2 / 12)), which is
# low where a rule moves the parameters little against their size (lars,
# trust coefficient 1e-3: dp/p ~ 4e-6, a floor near 40 dB; adadelta near
# 44 dB) and high where it moves them much (the Adam family near 115 dB).
# The CPU's own fp32 run of this probe (4 blocks, PERF.md) sits within 1.2
# dB of the floor for every name but adamw (4.7 dB below: torch's AdamW
# rounds twice a step, the decay and the update) and lion (2.8 dB above).
# A rule with a wrong moment, sign, factor or learning-rate use is 0-20 dB
# off float64 whatever the floor, so the limit is the floor less
# ``FLOOR_MARGIN_DB``, room for the card's order of operations and fused
# multiply-adds.
FLOOR_MARGIN_DB = 10.0
# a Lion flip needs |(1 - b1) g + b1 mu| within rounding of 0: about 1e-7
# of the elements a step for continuous data; 1e-5 of them bounds it with
# room, and one flip alone costs about 62 dB of the SNR
FLIP_SHARE_LIMIT = 1e-5
SIGN_RULES = ("lion",)
# the loss is a negative SNR in dB near 0 for seeded weights, so it is
# held in dB, not relative: fp32 moves it by about 1e-6 dB
LOSS_DB_LIMIT = 1e-3
N_SRC_MANY, MANY_BLOCKS = 6, 4


def _expect(ok, what):
    if not ok:
        raise AssertionError(what)


def _counts():
    return dw_conv_glob_ln.launches, dw_conv_glob_ln_backward.launches


# -- (a), (b): every optimizer name -------------------------------------------

def recipe_gradients(device="cuda", num_blocks=16, seed=0):
    """The recipe model's parameters (fp32, seeded) and the gradients of
    one backward at B=2 1 s on ``device``, stochastic layers off: two
    lists of tensors on ``device``."""
    model = TDANetBest(**{**train_step.RECIPE, "num_blocks": num_blocks})
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(device)
    mix, src = train_step.tone_batch(2, 1.0, seed=seed, device=device)
    loss_fn = PITLossWrapper(pairwise_neg_snr, threshold_byloss=True)
    loss = loss_fn(model(mix), src)
    params = [p for p in model.parameters()]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return [p.detach().clone() for p in params], [g.detach() for g in grads]


def step_gradients(grads, seed=1):
    """The 3 steps' gradients: g, -0.5 g and each tensor's elements in a
    seeded permutation."""
    gen = torch.Generator().manual_seed(seed)
    perm = []
    for g in grads:
        idx = torch.randperm(g.numel(), generator=gen).to(g.device)
        perm.append(g.reshape(-1)[idx].reshape(g.shape))
    return [grads, [-0.5 * g for g in grads], perm]


def run_optimizer(name, params0, steps):
    """3 steps of ``name`` from ``params0`` with the gradients of
    ``steps`` (the learning rate halved before the third, the clip at
    5); returns the parameters' change."""
    params = [torch.nn.Parameter(p.clone()) for p in params0]
    spec = topt.make_optimizer(name, lr=LR, grad_clip=CLIP)
    opt = spec.init(params)
    for i, grads in enumerate(steps):
        if i == 2:
            topt.set_learning_rate(opt, LR / 2)
        for p, g in zip(params, grads):
            p.grad = g.clone()
        spec.clip_([p.grad for p in params])
        opt.step()
    return [p.detach() - p0 for p, p0 in zip(params, params0)]


def compare_change(got, want, params64):
    """(SNR dB of the card's change against float64's over the elements
    that did not flip, the fp32 rounding floor of that SNR, the flipped
    elements): a flip is an element off by more than lr / 2 (a flip at the
    halved rate of step 3 moves it by lr), which only a sign rule may
    have."""
    got = torch.cat([g.double().cpu().reshape(-1) for g in got])
    want = torch.cat([w.reshape(-1) for w in want])
    flipped = (got - want).abs() > LR / 2
    keep = ~flipped
    after = torch.cat([p.reshape(-1) for p in params64]) + want
    moved = (want != 0) & keep
    exponent = torch.frexp(after[moved].abs().clamp_min(1e-38))[1]
    ulp = torch.ldexp(torch.ones_like(after[moved]), exponent - 24)
    floor = 10 * math.log10(want[keep].square().sum().item()
                            / (3 * ulp.square().sum().item() / 12))
    return snr_db(want[keep], got[keep]), floor, int(flipped.sum())


def drive_optimizers(device="cuda", num_blocks=16, log=print):
    """Part (a): every name's change on ``device`` against float64 on the
    CPU; returns {name: {snr_db, floor_db, flips}}, the elements, and the
    parameters and gradients (on ``device``)."""
    t0 = time.perf_counter()
    params, grads = recipe_gradients(device, num_blocks)
    n = sum(p.numel() for p in params)
    log(f"recipe gradients ({len(params)} tensors, {n} parameters, "
        f"largest {tuple(max(params, key=torch.numel).shape)}) in "
        f"{time.perf_counter() - t0:.1f} s")
    steps = step_gradients(grads)
    params64 = [p.double().cpu() for p in params]
    steps64 = [[g.double().cpu() for g in s] for s in steps]
    rows, t_ref = {}, 0.0
    for name in NAMES:
        got = run_optimizer(name, params, steps)
        t1 = time.perf_counter()
        want = run_optimizer(name, params64, steps64)
        t_ref += time.perf_counter() - t1
        snr, floor, flips = compare_change(got, want, params64)
        rows[name] = dict(snr_db=snr, floor_db=floor, flips=flips)
    worst = min(rows, key=lambda k: rows[k]["snr_db"] - rows[k]["floor_db"])
    log(f"{len(NAMES)} names, 3 steps each on {device} fp32 vs CPU float64 "
        f"({t_ref:.1f} s for the float64 runs): SNR of the parameter change "
        f"(the fp32 rounding floor; limit the floor less "
        f"{FLOOR_MARGIN_DB:g} dB), farthest below its floor {worst} "
        f"{rows[worst]['snr_db']:.1f} dB (floor "
        f"{rows[worst]['floor_db']:.1f})")
    log("  " + ", ".join(f"{k} {v['snr_db']:.1f} ({v['floor_db']:.1f})"
                         for k, v in rows.items()))
    for name, row in rows.items():
        limit = 0 if name not in SIGN_RULES else int(FLIP_SHARE_LIMIT * n)
        if name in SIGN_RULES:
            log(f"  {name}: {row['flips']} elements took the other sign "
                f"(limit {limit}, {FLIP_SHARE_LIMIT:g} of {n})")
        _expect(row["flips"] <= limit, f"{name}: {row['flips']} elements "
                                       f"off by more than lr / 2")
        _expect(row["snr_db"] >= row["floor_db"] - FLOOR_MARGIN_DB,
                f"{name}: the card's change is {row['snr_db']:.1f} dB from "
                f"float64's, its floor {row['floor_db']:.1f} dB")
    return rows, n, params, grads


def _bracket():
    """Two #1 launches on a small fixed site: the marks around a profiled
    optimizer step."""
    from tdanet_tpu_torch.probes.dw_sites import site_inputs
    x, *params = site_inputs(1, 64, 5, True, torch.Generator().manual_seed(0))

    def mark():
        for _ in range(2):
            dw_conv_glob_ln(x, *params)
    return mark


def time_optimizers(params, grads, card, log=print):
    """Part (b): each name's step() ms (median of 5 after 2, host clock
    around a synchronised step) and its device kernels in one profiled
    step; returns {name: {ms, runs, kernels, kernel_ms}}."""
    mark = _bracket()
    rows = {}
    for name in NAMES:
        ps = [torch.nn.Parameter(p.clone()) for p in params]
        for p, g in zip(ps, grads):
            p.grad = g.clone()
        opt = topt.make_optimizer(name, lr=LR).init(ps)
        runs = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.step()
            torch.cuda.synchronize()
            if i >= 2:
                runs.append((time.perf_counter() - t0) * 1e3)

        def read():
            with profiled() as prof:
                mark()
                opt.step()
                mark()
            events = device_kernels(prof)
            dw = sum(e.count for e in events
                     if train_step.FORWARD_NAME in e.key)
            rest = [e for e in events if train_step.FORWARD_NAME not in e.key]
            return dw, 4, (sum(e.count for e in rest),
                           sum(e.self_device_time_total for e in rest) / 1e3)

        kernels, kernel_ms = counted_windows(read, f"{name} step")
        rows[name] = dict(ms=statistics.median(runs), runs=runs,
                          kernels=kernels, kernel_ms=kernel_ms)
        del opt, ps
    log(f"optimizer step() on {sum(p.numel() for p in params)} parameters "
        f"in {len(params)} tensors, ms (median of 5 after 2) / device "
        f"kernels / device ms [{card}]:")
    for name, r in rows.items():
        log(f"  {name:10s} {r['ms']:7.3f} ms {r['kernels']:5d} kernels "
            f"{r['kernel_ms']:7.3f} ms")
    return rows


# -- (c): audio_train with adafactor and a resume ----------------------------

@contextlib.contextmanager
def restored_states():
    """Inside, each CheckpointManager restore is kept in the yielded list:
    (kind, path, the optimizer state saved in the file, the state dict of
    the optimizer it was loaded into), both on the CPU."""
    from tdanet_tpu_torch.system.checkpoint import CheckpointManager
    seen, real = [], CheckpointManager._restore

    def recording(self, kind, step, template):
        out = real(self, kind, step, template)
        path = self._path(kind, step)
        seen.append((kind, path, torch.load(
            path, map_location="cpu", weights_only=True)["optimizer"],
            _to_cpu(template.optimizer.state_dict())))
        return out
    CheckpointManager._restore = recording
    try:
        yield seen
    finally:
        CheckpointManager._restore = real


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return copy.deepcopy(tree)


def _same(a, b, path="optimizer"):
    """Raises where two state trees differ (tensors bit for bit)."""
    if isinstance(a, torch.Tensor):
        _expect(isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b),
                f"{path} differs from the saved state")
        return 1
    if isinstance(a, dict):
        _expect(isinstance(b, dict) and set(a) == set(b),
                f"{path}: keys differ")
        return sum(_same(a[k], b[k], f"{path}.{k}") for k in a)
    if isinstance(a, (list, tuple)):
        _expect(len(a) == len(b), f"{path}: lengths differ")
        return sum(_same(x, y, f"{path}[{i}]") for i, (x, y) in
                   enumerate(zip(a, b)))
    _expect(a == b, f"{path}: {a!r} != {b!r}")
    return 0


def drive_adafactor_training(tr, cv, exp, conf="configs/tdanet.yml",
                             extra=(), log=print):
    """Part (c), with the config's overrides ``extra`` (on the CPU, where
    no wrapper launches a kernel, #1's launches must be 0); returns the
    record: each run's #1 (forward, backward) launches and the expected
    ones, the history and the state tensors compared."""
    from tdanet_tpu_torch import audio_train
    from tdanet_tpu_torch.utils.parser import parse_config

    def config(epochs, *more):
        return parse_config([
            "--conf_dir", conf,
            f"datamodule.data_config.train_dir={tr}",
            f"datamodule.data_config.valid_dir={cv}",
            f"datamodule.data_config.test_dir={cv}",
            f"training.epochs={epochs}", f"main_args.exp_dir={exp}",
            "exp.project=null", "optimizer.optim_name=adafactor",
            *extra, *more])

    record, history = {}, []
    for run, (epochs, more) in enumerate(((1, ()),
                                          (2, ("main_args.resume=true",)))):
        dw_conv_glob_ln.launches = dw_conv_glob_ln_backward.launches = 0
        t0 = time.perf_counter()
        with restored_states() as seen:
            trainer = audio_train.main(config(epochs, *more))
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()
        launches = _counts()
        model = trainer.state.model
        _expect(type(trainer.state.optimizer) is topt.Adafactor,
                f"audio_train built {type(trainer.state.optimizer)}")
        steps = len(trainer.datamodule.train_dataloader())
        vals = len(trainer.datamodule.val_dataloader())
        blocks = model.num_blocks
        sites = 32 * blocks
        fwd, bwd = train_step.expected_launches("scales", sites, 3 * blocks)
        want = (steps * fwd + vals * sites, steps * bwd) \
            if trainer.device.type == "cuda" else (0, 0)
        log(f"audio_train adafactor run {run} ({'resume, ' if run else ''}"
            f"epoch {trainer.history[-1]['epoch']}): "
            f"{time.perf_counter() - t0:.1f} s, {steps} steps and {vals} "
            f"validation batches; #1 launches {launches} (expected {want}); "
            f"{trainer.history[-1]}")
        _expect(launches == want, f"#1 launches {launches}, expected {want}")
        _expect(all(math.isfinite(r[k]) for r in trainer.history
                    for k in ("train_loss", "val_loss")),
                f"a loss is not finite: {trainer.history}")
        history += trainer.history
        record[f"run{run}_launches"] = list(launches)
        record["expected_per_epoch"] = list(want)
        if run == 1:
            last = [r for r in seen if r[0] == "last"]
            _expect(len(last) == 1, f"{len(last)} restores of the last "
                                    f"checkpoint in the resume")
            _, path, saved, loaded = last[0]
            n = _same(saved, loaded)
            record["state_tensors_equal"] = n
            log(f"resumed optimizer state: {n} tensors equal to {path!r} "
                f"bit for bit")
            _expect(n > 0, "the saved optimizer state holds no tensor")
    record["history"] = history
    return record


# -- (d): six sources ---------------------------------------------------------

@contextlib.contextmanager
def recorded_assignments():
    """Inside, each of scipy's linear_sum_assignment calls' columns are
    kept in the yielded list."""
    import scipy.optimize
    seen, real = [], scipy.optimize.linear_sum_assignment

    def recording(cost):
        rows, cols = real(cost)
        seen.append(np.asarray(cols).copy())
        return rows, cols
    scipy.optimize.linear_sum_assignment = recording
    try:
        yield seen
    finally:
        scipy.optimize.linear_sum_assignment = real


def drive_many_sources(device="cuda", log=print):
    """Part (d); returns the record."""
    cfg = {**train_step.RECIPE, "num_blocks": MANY_BLOCKS,
           "num_sources": N_SRC_MANY}
    model = TDANetBest(**cfg)
    model.reset_parameters(torch.Generator().manual_seed(6))
    cpu64 = copy.deepcopy(model).double()
    model = model.to(device)
    loss_fn = PITLossWrapper(pairwise_neg_snr, threshold_byloss=True)
    mix, src = train_step.tone_batch(2, 1.0, seed=6, n_src=N_SRC_MANY,
                                     device=device)
    card_kinks = train_step.Kinks()
    before = _counts()
    with recorded_assignments() as card_perm, card_kinks():
        loss, grads = train_step.loss_and_grads(model, loss_fn, mix, src)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = tuple(a - b for a, b in zip(_counts(), before))
    t0 = time.perf_counter()
    ref_kinks = train_step.Kinks(card_kinks.masks)
    with recorded_assignments() as ref_perm, ref_kinks():
        loss64, g64 = train_step.loss_and_grads(
            cpu64, loss_fn, mix.cpu().double(), src.cpu().double())
    t_ref = time.perf_counter() - t0
    same = len(card_perm) == len(ref_perm) == 2 and all(
        np.array_equal(a, b) for a, b in zip(card_perm, ref_perm))
    off = abs(loss.item() - loss64.item())
    top = max(g.abs().max().item() for g in g64.values())
    zeros = {k for k, g in g64.items() if g.abs().max().item() <= 1e-9 * top}
    snrs = {k: snr_db(g64[k], grads[k].cpu()) for k in g64 if k not in zeros}
    low = min(snrs, key=snrs.get)
    log(f"6 sources, {MANY_BLOCKS} blocks, B=2 1 s fp32: assignments "
        f"{[a.tolist() for a in card_perm]} (CPU float64 "
        f"{[a.tolist() for a in ref_perm]}, {t_ref:.1f} s), loss "
        f"{loss.item():.6f} vs {loss64.item():.6f} dB (off {off:.1e} dB, "
        f"limit {LOSS_DB_LIMIT:g}); gradients lowest SNR {snrs[low]:.1f} dB "
        f"({low}; limit 50), {ref_kinks.flips} kink elements on the other "
        f"side in float64; #1 launches {launches}")
    want = train_step.expected_launches(False, 32 * MANY_BLOCKS,
                                        3 * MANY_BLOCKS) \
        if device == "cuda" else (0, 0)
    _expect(launches == want, f"#1 launches {launches}, expected {want}")
    _expect(same, "the Hungarian assignments differ from float64's")
    _expect(any((a != np.arange(N_SRC_MANY)).any() for a in card_perm),
            "every assignment is the identity: the check is blind")
    _expect(off <= LOSS_DB_LIMIT, f"loss off by {off:.2e} dB")
    _expect(snrs[low] >= 50.0, f"{low}: gradient {snrs[low]:.1f} dB")
    _expect(all(grads[k].abs().max().item() <= 1e-4 * top for k in zeros),
            "a structural zero gradient is not small on the card")
    record = dict(assignments=[a.tolist() for a in card_perm],
                  loss=loss.item(), loss64=loss64.item(), loss_off_db=off,
                  grad_min_snr_db=snrs[low], dw_launches=list(launches))
    if device != "cuda":
        return record
    del grads, model
    torch.cuda.empty_cache()
    row = train_step.time_steps(2, False, seconds=1.0,
                                compute_dtype=torch.float32,
                                num_blocks=MANY_BLOCKS,
                                num_sources=N_SRC_MANY)
    record.update(step_ms=row["ms"], step_runs=row["runs"],
                  step_launches=list(row["launches_per_step"]))
    return record


# -- (e): the audio-visual loader ---------------------------------------------

AV_SR, AV_FPS, AV_HW, AV_SEGMENT, AV_SECONDS, AV_UTT = \
    8000, 25, (88, 88), 2.0, 2.25, 4


def write_av_split(root, compressed, dtype, seed=7, hw=AV_HW,
                   mix_key="mix"):
    """AV_UTT utterances of AV_SECONDS (longer than the segment, so crops
    are drawn) and each source's mouth archive of ``hw`` frames, 3 fewer
    to 3 more than fps_len of them (some truncated, some short; the frame
    counts agree within an item, as the dataset's np.stack needs), with
    the manifests; ``np.savez_compressed`` where ``compressed``."""
    from tdanet_tpu_torch.utils.audio_io import write_wav
    rng = np.random.default_rng(seed)
    T = int(AV_SECONDS * AV_SR)
    fps_len = int(AV_SEGMENT * AV_FPS)
    save = np.savez_compressed if compressed else np.savez
    infos = {mix_key: [], "s1": [], "s2": []}
    for i in range(AV_UTT):
        s1, s2 = (0.1 * rng.standard_normal((2, T))).astype(np.float32)
        n_frames = fps_len + int(rng.integers(-3, 4))
        for ch, d in ((mix_key, s1 + s2), ("s1", s1), ("s2", s2)):
            p = os.path.join(root, ch, f"u{i}.wav")
            write_wav(p, d, AV_SR)
            if ch == mix_key:
                infos[ch].append([p, T])
                continue
            mp = os.path.join(root, ch, f"u{i}.npz")
            if dtype == np.uint8:
                data = rng.integers(0, 255, (n_frames, *hw)).astype(dtype)
            else:
                data = rng.standard_normal((n_frames, *hw)).astype(dtype)
            save(mp, data=data)
            infos[ch].append([p, mp, T])
    for ch, rows in infos.items():
        with open(os.path.join(root, f"{ch}.json"), "w") as f:
            json.dump(rows, f)
    return root


def drive_av(tmp, log=print):
    """Part (e); returns the record."""
    from tdanet_tpu_torch.datas import SeparationDataset
    from tdanet_tpu_torch.datas import native_loader
    record = dict(route=" ".join(native_loader.LIBS), cases={})
    log(f"native loader {native_loader.library_path().name}: zlib linked "
        f"({record['route']}), no in-source inflate")
    for compressed, dtype in ((False, np.float32), (True, np.float32),
                              (False, np.uint8)):
        case = f"{'deflated' if compressed else 'stored'} {dtype.__name__}"
        root = write_av_split(os.path.join(tmp, case.replace(" ", "_")),
                              compressed, dtype)
        ds = SeparationDataset(root, mix_key="mix", segment=AV_SEGMENT,
                               sample_rate=AV_SR, audio_only=False,
                               fps=AV_FPS)
        t0 = time.perf_counter()
        loader = native_loader.NativeLoader(ds, batch_size=2, shuffle=True,
                                            num_workers=2, seed=3)
        got = list(loader)
        seconds = time.perf_counter() - t0
        plain = list(native_loader.plain_batches(ds, 2, True, 3, 0))
        order = native_loader.epoch_order(len(ds), True, 3, 0)
        _expect(len(got) == len(plain) == AV_UTT // 2, "batch count")
        for b, (g, p) in enumerate(zip(got, plain)):
            for a, c in zip(g[:3], p[:3]):
                _expect(np.array_equal(a, c), f"{case}: batch {b} differs "
                                              f"from the plain draws")
            for k in range(2):
                item = ds.__getitem__(order[2 * b + k], None)
                nf = item[2].shape[1]
                _expect(np.array_equal(g[2][k][:, :nf],
                                       item[2].astype(np.float32))
                        and not g[2][k][:, nf:].any(),
                        f"{case}: batch {b} row {k}'s mouths differ from "
                        f"the item's")
        record["cases"][case] = dict(batches=len(got), seconds=seconds,
                                     mouth_shape=list(got[0][2].shape))
        log(f"AV loader, {case} archives: {len(got)} batches of mouths "
            f"{tuple(got[0][2].shape)} equal to the plain draws and the "
            f"dataset's items ({seconds:.2f} s)")
    bad = os.path.join(root, "s2", "u3.npz")
    with open(bad, "r+b") as f:
        f.seek(os.path.getsize(bad) // 2)
        f.write(b"\x00" * 64)
    try:
        list(native_loader.NativeLoader(ds, batch_size=2, num_workers=2))
    except RuntimeError as e:
        _expect(bad in str(e), f"the error does not name the file: {e}")
        log(f"a garbled archive raises: {e}")
        record["bad_archive_raises"] = True
    else:
        raise AssertionError("a garbled archive did not raise")
    return record


def drive_phase(card, tmp, data, log=print):
    """Phase 29: parts (a)-(e) from launch counts of 0, and one
    ``scripts.profile_train`` run; returns the record."""
    from tdanet_tpu_torch.scripts import profile_train
    dw_conv_glob_ln.launches = dw_conv_glob_ln_backward.launches = 0
    record = {}
    t0 = time.perf_counter()
    rows, n, params, grads = drive_optimizers(log=log)
    record["optimizers"] = dict(rows=rows, parameters=n, tensors=len(params))
    record["optimizer_step"] = time_optimizers(params, grads, card, log)
    del params, grads
    torch.cuda.empty_cache()
    log(f"(a), (b) in {time.perf_counter() - t0:.1f} s")
    record["adafactor_training"] = drive_adafactor_training(
        *data, os.path.join(tmp, "exp_adafactor"), log=log)
    record["many_sources"] = drive_many_sources(log=log)
    record["av"] = drive_av(os.path.join(tmp, "av"), log=log)
    dw_conv_glob_ln.launches = dw_conv_glob_ln_backward.launches = 0
    prof = profile_train.profile(
        "scales", os.path.join(tmp, "train_trace"), "adafactor", iters=2,
        log=log)
    record["profile_train"] = {k: prof[k] for k in (
        "mode", "optim", "ms_per_step", "kernels", "total_ms",
        "dw_launches")}
    record["card"] = card
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this probe runs on a GPU")
    card = card_line()
    print(card)
    # as chip_smoke.py's phase 1: float64 references want fp32 products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        from tdanet_tpu_torch.datas.preprocess import preprocess_dataset
        for split, n, seed in (("train-100", 16, 0), ("dev", 8, 1)):
            train_step.write_split(os.path.join(tmp, "corpus", split), n,
                                   seed=seed, manifests=False)
        preprocess_dataset(os.path.join(tmp, "corpus"),
                           os.path.join(tmp, "manifests"), "librimix")
        data = tuple(os.path.join(tmp, "manifests", s)
                     for s in ("train-100", "dev"))
        record = drive_phase(card, tmp, data)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    sys.exit(main() and 0)
