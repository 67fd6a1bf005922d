"""Phase 28 of ``chip_smoke.py``: the studies slice on the card.

    python -m tdanet_tpu_torch.probes.studies --ckpt <best_model.pth>
        [--out record.json]

- the convergence-corpus generator (``scripts/make_convergence_data``)
  writes a corpus at n_train 16 (dev and tt 100 each); one training batch
  drawn through the port's datamodule and native loader equals the plain
  draws (``native_loader.plain_batches``) bit for bit;
- the three studies (``scripts/probe_early_exit``, ``probe_progressive``,
  ``probe_act_quant_quality``) run through their ``main`` on the
  checkpoint at ``--n 8 --batch 8`` in bf16 with short timing loops; each
  printed line has the JAX scripts' keys and finite values, and #1's
  launches are exact from the sites: 32 a block iteration of every
  batched forward the study ran (from 0 just before each study);
- #1 against its plain version at every site the studies launched it at
  (bf16 activations over fp32 parameters, SNR >= 40 dB, phase 3's limit);
- ``ops.store_activation`` on CUDA tensors equals the same call on the CPU
  bit for bit in every mode, fp32 and bf16, values past both fp8 ranges
  included.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from tdanet_tpu_torch import ops
from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_reference)
from tdanet_tpu_torch.probes.eval_path import (recorded_sites,
                                               sites_per_block, snr_db)

N, BATCH, ITERS = 8, 8, 2
N_TRAIN = 16
BF16_LIMIT_DB = 40.0


def _expect(ok, what):
    if not ok:
        raise AssertionError(what)


def drive_generator(tmp, log=print):
    """The corpus at n_train ``N_TRAIN`` under ``tmp/convergence``, its
    file census, a wav read back against the generator's own draws, and
    one training batch of the native loader against the plain draws.
    Returns the record."""
    from tdanet_tpu_torch.datas import Libri2MixDataModule
    from tdanet_tpu_torch.datas.native_loader import (NativeLoader,
                                                      plain_batches)
    from tdanet_tpu_torch.scripts import make_convergence_data as gen
    from tdanet_tpu_torch.utils.audio_io import read_wav
    root = os.path.join(tmp, "convergence")
    t0 = time.perf_counter()
    gen.make_corpus(root, N_TRAIN, log=log)
    seconds = time.perf_counter() - t0
    sizes = {"tr": N_TRAIN, "dev": gen.N_HELD_OUT, "tt": gen.N_HELD_OUT}
    for split, n in sizes.items():
        for ch in ("mix_clean", "s1", "s2"):
            with open(os.path.join(root, split, f"{ch}.json")) as f:
                rows = json.load(f)
            _expect(len(rows) == n and all(r[1] == 3 * gen.SR for r in rows),
                    f"{split}/{ch}.json lists {len(rows)} rows")
    mix, srcs = gen.utterance(gen.SEEDS["tt"] + 7)
    got = read_wav(os.path.join(root, "tt", "s2", "utt0007.wav"))[0]
    _expect(np.array_equal(got, srcs[1]), "a wav differs from its draws")
    dm = Libri2MixDataModule(
        train_dir=os.path.join(root, "tr"),
        valid_dir=os.path.join(root, "dev"),
        test_dir=os.path.join(root, "tt"), n_src=2, sample_rate=gen.SR,
        segment=3.0, batch_size=BATCH, num_workers=2)
    dm.setup()
    loader = dm.train_dataloader()
    _expect(isinstance(loader, NativeLoader), f"{type(loader).__name__}")
    epoch = loader.epoch
    bmix, bsrc, _ = next(iter(loader))
    wmix, wsrc, _ = next(iter(plain_batches(loader.ds, loader.batch_size,
                                            loader.shuffle, loader.seed,
                                            epoch)))
    equal = np.array_equal(bmix, wmix) and np.array_equal(bsrc, wsrc)
    _expect(equal, "the native loader's batch differs from the plain draws")
    del loader
    log(f"corpus at n_train {N_TRAIN}: {sum(sizes.values())} utterances x 3 "
        f"channels in {seconds:.2f} s; a native-loader batch "
        f"{tuple(bmix.shape)} equal to the plain draws")
    return {"seconds": seconds, "utterances": sizes,
            "loader_batch_equal": equal}


def _run(main, argv):
    """``main(argv)``'s return value and its stdout's JSON lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    text = buf.getvalue()
    print(text, end="")
    return out, [json.loads(line) for line in text.splitlines()]


def _finite(d):
    return all(isinstance(v, str) or math.isfinite(v) for v in d.values())


def drive_probes(ckpt, log=print):
    """The three studies through their ``main`` on the card; #1's launches
    of each against 32 a block iteration of its forwards. Returns the
    record and the site keys #1 ran at."""
    from tdanet_tpu_torch.models import BaseModel
    from tdanet_tpu_torch.scripts import probe_act_quant_quality as quant
    from tdanet_tpu_torch.scripts import probe_early_exit as early
    from tdanet_tpu_torch.scripts import probe_progressive as prog
    model = BaseModel.from_pretrain(ckpt)
    per_iter, full = sites_per_block(model), model.num_blocks
    batches = -(-N // BATCH)
    common = ["--ckpt", ckpt, "--n", str(N), "--batch", str(BATCH),
              "--device", "cuda"]
    record = {}
    with recorded_sites() as seen:
        t0 = time.perf_counter()
        dw_conv_glob_ln.launches = 0
        _, lines = _run(early.main, [*common, "--iters", str(ITERS)])
        launches = dw_conv_glob_ln.launches
        want = per_iter * sum(d * (batches + 1 + ITERS)
                              for d in early.DEPTHS)
        _expect([r["depth"] for r in lines] == list(early.DEPTHS)
                and all(sorted(r) == ["depth", "rtfx", "sisnri_db"]
                        and _finite(r) for r in lines),
                f"probe_early_exit printed {lines}")
        _expect(launches == want,
                f"probe_early_exit: #1 launches {launches}, expected {want}")
        record["early_exit"] = {"lines": lines, "launches": launches,
                                "seconds": time.perf_counter() - t0}

        t0 = time.perf_counter()
        dw_conv_glob_ln.launches = 0
        (_, census), lines = _run(prog.main,
                                  [*common, "--iters", str(ITERS)])
        launches = dw_conv_glob_ln.launches
        want = per_iter * sum(d * -(-rows // BATCH) for d, rows in census)
        curve = lines[3:]
        _expect(len(lines) == 3 + len(prog.QUANTILES)
                and sorted(lines[0]["proxy"]) == sorted(
                    ["d1", "pearson_r", "spearman_r", "gain_db_mean",
                     "delta_min", "delta_max"])
                and [ln["fixed"]["depth"] for ln in lines[1:3]] == [full, 8]
                and all(sorted(ln) == sorted(
                    ["threshold_q", "threshold", "escalated_frac",
                     "sisnri_db", "rtfx", "vs16_db"]) for ln in curve)
                and all(_finite(ln.get("proxy") or ln.get("fixed") or ln)
                        for ln in lines),
                f"probe_progressive printed {lines}")
        # the census's stage-2 rows of each threshold's runs (the first,
        # the warm one and the timed ones; each run a stage-1 entry, then
        # a stage-2 one) are the escalations it printed
        runs = census[3 + 2 * (1 + ITERS):]
        per_q = 2 * (2 + ITERS)
        for k, ln in enumerate(curve):
            esc = {rows for _, rows in runs[k * per_q + 1:(k + 1) * per_q:2]}
            _expect(esc == {round(ln["escalated_frac"] * N)},
                    f"threshold {ln['threshold_q']}: escalations {esc}, "
                    f"printed {ln['escalated_frac']}")
        _expect(launches == want,
                f"probe_progressive: #1 launches {launches}, expected "
                f"{want}")
        record["progressive"] = {"lines": lines, "launches": launches,
                                 "seconds": time.perf_counter() - t0}

        t0 = time.perf_counter()
        dw_conv_glob_ln.launches = 0
        _, lines = _run(quant.main, common)
        launches = dw_conv_glob_ln.launches
        want = per_iter * len(ops.ACT_STORAGE_MODES) * batches * full
        _expect([r["storage"] for r in lines] == ["off", "int8", "fp8_e4m3",
                                                  "fp8_e5m2"]
                and all(_finite(r) for r in lines),
                f"probe_act_quant_quality printed {lines}")
        _expect(launches == want, f"probe_act_quant_quality: #1 launches "
                                  f"{launches}, expected {want}")
        record["act_quant"] = {"lines": lines, "launches": launches,
                               "seconds": time.perf_counter() - t0}
    torch.cuda.synchronize()
    log(f"#1 launches: early exit {record['early_exit']['launches']}, "
        f"progressive {record['progressive']['launches']}, act storage "
        f"{record['act_quant']['launches']}, each exact")
    return record, seen, model.in_channels


def check_sites(keys, C, seed=28):
    """#1 against its plain version (fp32 on the same values) at every
    site key the studies ran, on seeded operands made on the card: bf16
    activations over fp32 parameters, SNR >= 40 dB. Returns the lowest
    SNR."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    low = math.inf
    with torch.inference_mode():
        for B, T, K, stride, bias, t_inner, dtype in sorted(keys):
            _expect(dtype == "torch.bfloat16" and t_inner,
                    f"a study ran #1 at {dtype}, T innermost {t_inner}")
            x = randn(B, C, T).bfloat16().transpose(1, 2)  # (B, T, C)
            params = (randn(C, 1, K) * 0.2, randn(C) * 0.1 if bias else
                      None, randn(C), randn(C))
            got = dw_conv_glob_ln(x, *params, stride=stride, K=K)
            ref = dw_conv_glob_ln_reference(x.float(), *params,
                                            stride=stride, K=K)
            snr = snr_db(ref, got.float())
            _expect(snr >= BF16_LIMIT_DB,
                    f"#1 at B={B} T={T} K={K} s={stride}: {snr:.2f} dB")
            low = min(low, snr)
    torch.cuda.synchronize()
    return low


def store_inputs(seed=0):
    """Seeded values at three scales and past both fp8 ranges."""
    rng = np.random.default_rng(seed)
    edge = [448.0, 464.0, 464.00003, 465.0, 500.0, 1e4, -7e4, 57344.0,
            61440.0, 61441.0, 7e4, 1e6, 1e-9, 0.0, -0.0]
    x = np.concatenate([rng.standard_normal(40000),
                        40 * rng.standard_normal(4000),
                        3e3 * rng.standard_normal(4000), edge])
    return np.resize(x, (4, 64, 200)).astype(np.float32)


def check_store():
    """``store_activation`` on the card against the CPU, bit for bit;
    returns the number of (mode, dtype) cases and of NaNs seen."""
    base = torch.from_numpy(store_inputs())
    cases, nans = 0, 0
    for dtype in (torch.float32, torch.bfloat16):
        x = base.to(dtype)
        for mode in ("int8", "fp8_e4m3", "fp8_e5m2"):
            with ops.act_storage(mode):
                cpu = ops.store_activation(x)
                gpu = ops.store_activation(x.cuda()).cpu()
            same = torch.equal(torch.isnan(cpu), torch.isnan(gpu)) and \
                torch.equal(torch.nan_to_num(cpu), torch.nan_to_num(gpu))
            _expect(same, f"store_activation {mode} {dtype}: the card "
                          f"differs from the CPU")
            cases, nans = cases + 1, nans + int(torch.isnan(gpu).sum())
    _expect(nans > 0, "no fp8_e4m3 NaN past 464")
    return cases, nans


def drive_studies(ckpt, tmp, log=print):
    """Phase 28; returns its record."""
    t0 = time.perf_counter()
    corpus = drive_generator(tmp, log)
    probes, seen, C = drive_probes(ckpt, log)
    low = check_sites(seen, C)
    log(f"#1 against plain at the {len(seen)} site shapes of the studies "
        f"(bf16 over fp32 parameters): lowest {low:.2f} dB")
    cases, nans = check_store()
    log(f"store_activation: card equal to the CPU bit for bit in {cases} "
        f"cases ({nans} NaNs past fp8_e4m3's range among them)")
    return {"corpus": corpus, **probes, "sites": len(seen),
            "site_min_snr_db": low, "store_cases": cases,
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("studies needs a CUDA card")
    with tempfile.TemporaryDirectory() as tmp:
        record = drive_studies(args.ckpt, tmp)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({k: record[k] for k in ("sites", "site_min_snr_db",
                                              "store_cases", "seconds")}))


if __name__ == "__main__":
    main()
