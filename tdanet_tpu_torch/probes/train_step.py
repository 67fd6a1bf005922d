"""The training recipe's step on the card: its time and peak memory with
and without per-iteration checkpointing, its launches of kernel #1, and a
profile.

    python -m tdanet_tpu_torch.probes.train_step [--batch 8]
        [--remat on,off] [--out record.json]

The recipe is ``configs/tdanet.yml``: TDANetBest out 128, in 512, 16
blocks, depth 5, 4 ms encoder, 2 sources, 8 kHz, 3 s segments, bf16
activations over fp32 parameters, PIT neg-SNR with threshold_byloss, Adam
2e-3 with a global-norm clip of 5, dropout and drop-path on. A step is
forward, loss, backward, clip and update, timed on the host clock around
work that ends in a synchronize (median of 5 after 2 warm-up steps); the
peak is ``torch.cuda.max_memory_allocated`` over those steps.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    DwConvGlobLnFunction, dw_conv_glob_ln, dw_conv_glob_ln_backward)
from tdanet_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
from tdanet_tpu_torch.ops import basic
from tdanet_tpu_torch.system.optimizers import make_optimizer
from tdanet_tpu_torch.system.trainer import (create_train_state,
                                             make_train_step)
from tdanet_tpu_torch.utils.timing import card_line, snr_db

RECIPE = dict(out_channels=128, in_channels=512, num_blocks=16,
              upsampling_depth=5, enc_kernel_size=4, num_sources=2,
              sample_rate=8000)
FORWARD_NAME = "dw_conv_glob_ln_kernel"    # device kernels of #1
BACKWARD_NAME = "dw_conv_glob_ln_backward_kernel"


def tone_batch(B, seconds=3.0, sr=8000, seed=0):
    """(mixtures (B, T), sources (B, 2, T)): two tones plus noise a row."""
    rng = np.random.default_rng(seed)
    T = int(seconds * sr)
    t = np.arange(T) / sr
    src = np.stack([np.stack([
        0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * t
                     + rng.uniform(0, 6)) + 0.02 * rng.standard_normal(T)
        for _ in range(2)]) for _ in range(B)]).astype(np.float32)
    return torch.from_numpy(src.sum(1)).cuda(), torch.from_numpy(src).cuda()


def tone_mix(seconds, seed, sr=16000):
    """Two tones plus noise, summed: one mixture (numpy float32)."""
    rng = np.random.default_rng(seed)
    T = int(round(seconds * sr))
    t = np.arange(T) / sr
    srcs = [0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * t
                         + rng.uniform(0, 6))
            + 0.02 * rng.standard_normal(T) for _ in range(2)]
    return np.sum(srcs, axis=0).astype(np.float32)


def write_split(root, n, seed, seconds=3.5, sr=8000):
    """n utterances of two tone-plus-noise sources and their mixture, with
    the manifests the data modules read."""
    from tdanet_tpu_torch.utils import write_wav
    rng = np.random.default_rng(seed)
    T = int(seconds * sr)
    t = np.arange(T) / sr
    infos = {"mix_clean": [], "s1": [], "s2": []}
    for i in range(n):
        srcs = [0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * t
                             + rng.uniform(0, 6))
                + 0.02 * rng.standard_normal(T) for _ in range(2)]
        for key, data in (("mix_clean", srcs[0] + srcs[1]), ("s1", srcs[0]),
                          ("s2", srcs[1])):
            path = os.path.join(root, key, f"utt{i}.wav")
            write_wav(path, data, sr)
            infos[key].append([path, T])
    for key, rows in infos.items():
        with open(os.path.join(root, f"{key}.json"), "w") as f:
            json.dump(rows, f)


def setup(remat, seed=0, model="TDANetBest", **overrides):
    """(state, step) of the recipe's widths on the card for the registered
    ``model``, weights from ``seed``."""
    from tdanet_tpu_torch import models
    model = models.get(model)(**{**RECIPE, **overrides}, remat=remat)
    tx = make_optimizer("adam", lr=2e-3, grad_clip=5.0)
    state = create_train_state(model, tx,
                               torch.Generator().manual_seed(seed),
                               device="cuda")
    step = make_train_step(model, PITLossWrapper(pairwise_neg_snr,
                                                 threshold_byloss=True), tx,
                           compute_dtype=torch.bfloat16)
    return state, step


def counts():
    return dw_conv_glob_ln.launches, dw_conv_glob_ln_backward.launches


def _expect(ok, what):
    if not ok:
        raise AssertionError(what)


def loss_and_grads(model, loss_fn, mix, src, **kw):
    """One forward and backward; (loss, {name: gradient})."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model(mix, **kw), src)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()
                           if p.grad is not None}


class Kinks:
    """Which side of its kink each element of every piecewise-linear
    activation took (PReLU, ReLU, ReLU6, hard swish, leaky ReLU), and
    each channel max's choice, call by call: recorded from one run
    (``masks`` None) or imposed on another (``masks`` a recording), whose
    forward and gradient then take the recorded side whatever its own
    values say. A float64 reference run so at the card's pattern has the
    card's derivative at every kink: its gradient differs from plain
    float64's only where an element lies within rounding of a kink
    (``flips`` counts those elements), and an element on the other side
    of a PReLU's kink moves every gradient upstream of it by a step of
    (1 - slope) x its own gradient, which no fp32 arithmetic avoids."""

    def __init__(self, masks=None):
        self.recording = masks is None
        self.masks = [] if masks is None else masks
        self.calls = self.flips = 0

    def side(self, *own):
        """The masks of one call: ``own`` recorded, or the recording's."""
        if self.recording:
            self.masks.append(tuple(m.detach().cpu() for m in own))
            return own
        rec = self.masks[self.calls]
        self.calls += 1
        if [m.shape for m in rec] != [m.shape for m in own]:
            raise AssertionError("the replayed run's kinks differ in shape "
                                 "from the recorded run's")
        rec = tuple(m.to(o.device) for m, o in zip(rec, own))
        self.flips += sum(int((m != o).sum()) for m, o in zip(rec, own))
        return rec

    def prelu(self, x, weight):
        a = weight.to(x.dtype)
        a = a[0] if a.shape[0] == 1 else a.reshape(
            (1, -1) + (1,) * (x.ndim - 2))
        pos, = self.side(x >= 0)
        return torch.where(pos, x, a * x)

    def relu(self, x, inplace=False):
        pos, = self.side(x > 0)
        return torch.where(pos, x, torch.zeros_like(x))

    def relu6(self, x, shift=0.0):
        lo, hi = self.side(x + shift > 0, x + shift < 6)
        y = torch.where(hi, x + shift, torch.full_like(x, 6.0))
        return torch.where(lo, y, torch.zeros_like(x))

    def activation(self, name, x, prelu_weight=None):
        name = name.lower()
        if name == "prelu":
            return self.prelu(x, prelu_weight)
        if name == "relu":
            return self.relu(x)
        if name == "relu6":
            return self.relu6(x)
        if name == "hswish":
            return x * self.relu6(x, 3.0) / 6.0
        if name == "leakyrelu":
            return self.prelu(x, torch.full((1,), 0.2, dtype=x.dtype,
                                            device=x.device))
        return self.plain["activation"](name, x, prelu_weight)

    def amax(self, x, dim, keepdim=False):
        idx, = self.side(x.argmax(dim=dim, keepdim=True))
        y = x.gather(dim, idx)
        return y if keepdim else y.squeeze(dim)

    @contextlib.contextmanager
    def __call__(self):
        """Inside, the model's activations and channel maxes go through
        this recording."""
        F = torch.nn.functional
        self.plain = dict(prelu=basic.prelu, activation=basic.activation,
                          relu=F.relu, amax=torch.Tensor.amax)
        basic.prelu, basic.activation = self.prelu, self.activation
        F.relu = self.relu
        torch.Tensor.amax = lambda t, *a, **k: self.amax(t, *a, **k)
        try:
            yield self
        finally:
            basic.prelu = self.plain["prelu"]
            basic.activation = self.plain["activation"]
            F.relu, torch.Tensor.amax = self.plain["relu"], self.plain["amax"]


def check_gradients(model, sites, dead=0, seed=3, limit_db=50.0):
    """``model`` (on the CPU, fp32, seeded) at B=2, 1 s fp32 on the card:
    #1's (forward, backward) launches of one step exactly (sites, sites -
    dead) without checkpointing and (2 sites, sites - dead) with it
    (``dead`` sites never reach the loss); each parameter's gradient
    against the same model in float64 on the CPU taken at the card step's
    side of every activation kink (:class:`Kinks`), SNR >= ``limit_db``;
    with dropout on, the gradients with and without checkpointing equal
    to >= 60 dB. Returns (the lowest SNR, {remat: launches}, the elements
    whose own float64 values lie on the other side of a kink)."""
    name = type(model).__name__
    loss_fn = PITLossWrapper(pairwise_neg_snr, threshold_byloss=True)
    cpu64 = copy.deepcopy(model).double()
    model = model.cuda()
    mix, src = tone_batch(2, seconds=1.0, seed=seed)
    grads, launches = {}, {}
    card_kinks = Kinks()
    for remat, want in ((False, (sites, sites - dead)),
                        (True, (2 * sites, sites - dead))):
        model.sm.remat = remat
        before = counts()
        with card_kinks() if not remat else contextlib.nullcontext():
            loss, grads[remat] = loss_and_grads(model, loss_fn, mix, src)
        torch.cuda.synchronize()
        got = launches[remat] = tuple(
            a - b for a, b in zip(counts(), before))
        print(f"{name} step B=2 1 s fp32, checkpointing {remat}: loss "
              f"{loss.item():.4f}; #1 launches forward {got[0]}, backward "
              f"{got[1]} (expected {want})")
        _expect(got == want, f"{got} launches of #1 (forward, backward) in "
                             f"one step, expected {want}")
    t0 = time.perf_counter()
    ref_kinks = Kinks(card_kinks.masks)
    with ref_kinks():
        loss64, g64 = loss_and_grads(cpu64, loss_fn, mix.cpu().double(),
                                     src.cpu().double())
    flips = ref_kinks.flips
    _expect(ref_kinks.calls == len(card_kinks.masks), "the float64 run "
            "passed fewer activation kinks than the card's step")
    print(f"CPU float64 plain path at the card's side of every activation "
          f"kink ({ref_kinks.calls} calls; {flips} elements lie on the other "
          f"side in float64): loss {loss64.item():.4f} "
          f"({time.perf_counter() - t0:.1f} s)")
    _expect(set(g64) == set(grads[False]), "the card and the CPU differ in "
            "which parameters have a gradient")
    # a structural zero (a bias that a one-channel GroupNorm takes out
    # again) is rounding noise on both sides: no SNR, only a size check
    top = max(g.abs().max().item() for g in g64.values())
    zeros = {n for n, g in g64.items() if g.abs().max().item() <= 1e-9 * top}
    for n in sorted(zeros):
        got = grads[False][n].abs().max().item()
        print(f"  {n}: a structural zero, card max|g| {got:.2e} (limit "
              f"{1e-4 * top:.2e}, 1e-4 of the largest gradient)")
        _expect(got <= 1e-4 * top, f"{n} should be zero: {got:.3e}")
    snrs = {n: snr_db(g64[n], grads[False][n].cpu()) for n in g64
            if n not in zeros}
    low = sorted(snrs.items(), key=lambda kv: kv[1])
    print(f"{len(snrs)} parameter gradients, card fp32 vs CPU float64 at "
          f"the card's kinks: "
          f"lowest SNR {low[0][1]:.2f} dB ({low[0][0]}), median "
          f"{statistics.median(snrs.values()):.2f} dB (limit {limit_db:g})")
    for n, v in low[:3]:
        print(f"  {v:.2f} dB {n}")
    bad = [n for n, v in snrs.items() if v < limit_db]
    _expect(not bad, f"gradients disagree with the CPU: {bad[:5]}")
    drop = {}
    for remat in (False, True):
        model.sm.remat = remat
        _, drop[remat] = loss_and_grads(
            model, loss_fn, mix, src, training=True,
            generator=torch.Generator().manual_seed(5))
    same = min(snr_db(drop[False][n], drop[True][n]) for n in drop[False]
               if n not in zeros)
    print(f"dropout on: gradients with and without checkpointing, lowest "
          f"SNR {same:.2f} dB (limit 60)")
    _expect(same >= 60.0, "checkpointed gradients differ with dropout on")
    torch.cuda.synchronize()
    return low[0][1], launches, flips


def train_and_resume(conf, tr, cv, exp):
    """``audio_train.main`` on the config file ``conf`` through the
    port's parser, with the data dirs ``tr`` and ``cv``: 2 epochs from
    #1's launch counts at 0, then a resume for a third. Checks a finite
    history, best_model.pth's forward against the trained best model's
    (2 s at 8 kHz, fp32) and the resumed epoch. Returns (trainer, resumed
    trainer, #1's (forward, backward) launches of the 2 epochs)."""
    from tdanet_tpu_torch import audio_train
    from tdanet_tpu_torch.models import BaseModel
    from tdanet_tpu_torch.utils.parser import parse_config

    def config(epochs, *extra):
        return parse_config([
            "--conf_dir", conf,
            f"datamodule.data_config.train_dir={tr}",
            f"datamodule.data_config.valid_dir={cv}",
            f"datamodule.data_config.test_dir={cv}",
            f"training.epochs={epochs}", f"main_args.exp_dir={exp}",
            "exp.project=null", *extra])

    dw_conv_glob_ln.launches = dw_conv_glob_ln_backward.launches = 0
    t0 = time.perf_counter()
    trainer = audio_train.main(config(2))
    torch.cuda.synchronize()
    launches = counts()
    print(f"audio_train.main {conf}: 2 epochs in "
          f"{time.perf_counter() - t0:.1f} s (first calls included); #1 "
          f"launches forward {launches[0]}, backward {launches[1]}")
    hist = trainer.history
    _expect([r["epoch"] for r in hist] == [0, 1] and all(
        np.isfinite([r["train_loss"], r["val_loss"]]).all() for r in hist),
        f"bad history {hist}")
    for name in ("history.json", "best_k_models.json", "best_model.pth",
                 "conf.yml", "extras.json"):
        _expect(os.path.exists(os.path.join(exp, name)),
                f"no {name} in the experiment dir")
    loaded = BaseModel.from_pretrain(
        os.path.join(exp, "best_model.pth")).cuda()
    _expect(type(loaded) is type(trainer.best_model),
            f"best_model.pth holds {type(loaded).__name__}")
    wav = torch.from_numpy(tone_mix(2.0, seed=4, sr=8000)).cuda()[None]
    with torch.no_grad():
        a, b = loaded(wav), trainer.best_model(wav)
    err = ((a - b).abs().max() / b.abs().max()).item()
    print(f"from_pretrain(best_model.pth) vs the trained best model, 2 s "
          f"fp32 forward: max|d|/max|ref| {err:.2e} (limit 1e-6)")
    _expect(err <= 1e-6 and bool(torch.isfinite(a).all()),
            "best_model.pth does not give the trained model's forward")
    resumed = audio_train.main(config(3, "main_args.resume=true"))
    _expect([r["epoch"] for r in resumed.history] == [2],
            f"resume ran {resumed.history}")
    print(f"resume: epoch 2 only, {resumed.history[0]}")
    return trainer, resumed, launches


def time_steps(B, remat, steps=5, warmup=2, model="TDANetBest",
               **overrides):
    """The step's median ms over ``steps`` after ``warmup``, its runs, the
    peak allocated bytes, and #1's forward and backward launches per
    step, for the registered ``model`` at the recipe's widths (and
    ``overrides`` of its constructor's arguments)."""
    state, step = setup(remat, model=model, **overrides)
    mix, src = tone_batch(B)
    for i in range(warmup):
        state, loss = step(state, mix, src,
                           torch.Generator().manual_seed(i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    before = counts()
    for i in range(steps):
        t0 = time.perf_counter()
        state, loss = step(state, mix, src,
                           torch.Generator().manual_seed(100 + i))
        loss.item()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    per_step = tuple((a - b) // steps for a, b in zip(counts(), before))
    row = dict(model=model, B=B, remat=bool(remat),
               ms=statistics.median(runs), runs=runs,
               peak_bytes=torch.cuda.max_memory_allocated(),
               launches_per_step=per_step, loss=loss.item())
    print(f"{model} train step B={B} 3 s bf16 checkpointing "
          f"{'on' if remat else 'off'}: median {row['ms']:.1f} ms (runs "
          f"{[round(r, 1) for r in runs]}), peak "
          f"{row['peak_bytes'] / 2**30:.2f} GiB allocated; #1 launches per "
          f"step forward {per_step[0]}, backward {per_step[1]} "
          f"[{card_line()}]", flush=True)
    del state, step
    torch.cuda.empty_cache()
    return row


def profile_step(B, remat):
    """One profiled step after a warm-up: device kernels, device ms, and
    #1's forward and backward kernels and device ms."""
    from torch.profiler import ProfilerActivity, profile
    state, step = setup(remat)
    mix, src = tone_batch(B)
    state, loss = step(state, mix, src, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    copies = DwConvGlobLnFunction.dy_copies
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, mix, src,
                           torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    dev = lambda e: e.self_device_time_total / 1e3  # noqa: E731 (ms)
    pick = lambda name: [e for e in events if name in e.key]  # noqa: E731
    fwd, bwd = pick(FORWARD_NAME), pick(BACKWARD_NAME)
    result = dict(kernels=sum(e.count for e in events),
                  device_ms=sum(dev(e) for e in events), wall_ms=wall,
                  forward_kernels=sum(e.count for e in fwd),
                  forward_ms=sum(dev(e) for e in fwd),
                  backward_kernels=sum(e.count for e in bwd),
                  backward_ms=sum(dev(e) for e in bwd),
                  dy_copies=DwConvGlobLnFunction.dy_copies - copies,
                  top=[(dev(e), e.count, e.key[:90]) for e in
                       sorted(events, key=dev, reverse=True)[:10]])
    print(f"profiled train step B={B} checkpointing "
          f"{'on' if remat else 'off'}: {result['kernels']} device kernels,"
          f" {result['device_ms']:.2f} ms device time in {wall:.1f} ms wall "
          f"(profiler on); #1 forward {result['forward_kernels']} kernels "
          f"{result['forward_ms']:.2f} ms, backward "
          f"{result['backward_kernels']} kernels {result['backward_ms']:.2f}"
          f" ms; dy copied to x's layout {result['dy_copies']} times "
          f"[{card_line()}]")
    for ms, n, key in result["top"]:
        print(f"  {ms:8.3f} ms {n:5d}x {key}")
    del state, step
    torch.cuda.empty_cache()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--remat", default="on,off")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this probe runs on a GPU")
    print(card_line())
    rows = [time_steps(args.batch, flag == "on")
            for flag in args.remat.split(",")]
    record = dict(card=card_line(), rows=rows,
                  profile=profile_step(args.batch, True))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    sys.exit(main() and 0)
