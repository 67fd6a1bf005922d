"""Where an exported program and the model it was exported from part, op
by op. The bench model (phase 4's configuration, seeded random weights)
is exported as a bundle's bucket is (``deploy.export_forward``, saved and
loaded again), and the program and the model's forward run on one batch:
each eagerly twice, and each captured as one CUDA graph
(``serving.Program``). Then both run eagerly once more under a dispatch
log that records every ATen op and a checksum of its output (#1 through
its registered op in both, so the two logs align op for op), and the
first op whose checksum differs is printed with its operands.

    python -m tdanet_tpu_torch.probes.export_parity [--dtype bfloat16]
        [--deterministic] [--blocks 16] [--batch 8] [--seconds 2.0]
        [--device cuda] [--out record.json]

``--deterministic`` sets cuDNN's deterministic algorithms for the whole
run. The last line is the record as JSON: the SNRs (dB) of the program's
output against the model's and of each against its own second run, eager
and replayed, and the first differing op.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tdanet_tpu_torch import deploy
from tdanet_tpu_torch.kernels import dw_conv_glob_ln as dw
from tdanet_tpu_torch.models import TDANetBest
from tdanet_tpu_torch.probes.serve_path import CFG
from tdanet_tpu_torch.serving import Program, _estimates
from tdanet_tpu_torch.utils.timing import card_line, snr_db


def _desc(a):
    if isinstance(a, torch.Tensor):
        return (f"{tuple(a.shape)} {str(a.dtype)[6:]} stride {a.stride()}"
                f" offset {a.storage_offset()}")
    if isinstance(a, (list, tuple)):
        return "[" + ", ".join(_desc(b) for b in a) + "]"
    return repr(a)[:40]


class _OpLog(TorchDispatchMode):
    """Every ATen op run inside: (name, float64 sum of its first floating
    output or None, its operands)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        first = out[0] if isinstance(out, (tuple, list)) else out
        checksum = None
        if isinstance(first, torch.Tensor) and first.is_floating_point():
            checksum = first.double().sum().item()
        name = str(func)
        if not name.startswith(("aten.empty", "aten._assert_tensor")):
            self.ops.append((name, checksum, _desc(args)))
        return out


def _logged(fn, x):
    """fn(x)'s ops, with #1 called through its registered op (as a
    program calls it) rather than its implementation."""
    impl = dw._IMPL
    dw._IMPL = {k: (lambda *a: dw.OP(*a)) for k in impl}
    try:
        with torch.inference_mode(), _OpLog() as log:
            fn(x)
    finally:
        dw._IMPL = impl
    return log.ops


def first_difference(a, b):
    """The index of the first op whose name or checksum differs in two
    aligned logs, or None."""
    for i, (u, v) in enumerate(zip(a, b)):
        if u[:2] != v[:2]:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def run(dtype, blocks, batch, seconds, device):
    torch.manual_seed(0)
    model = TDANetBest(**{**CFG, "num_blocks": blocks})
    model.reset_parameters(torch.Generator().manual_seed(1234))
    model = model.to(device).eval()
    T = int(seconds * CFG["sample_rate"])
    T = -(-T // model.lcm) * model.lcm
    x = (torch.randn(batch, T, generator=torch.Generator().manual_seed(1))
         * 0.1).to(device)

    def fwd(t):
        return _estimates(model(t, per_utterance=True, compute_dtype=dtype))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "program.pt2")
        torch.export.save(deploy.export_forward(
            model, T, batch, dtype, device=device), path)
        program = torch.export.load(path).module()

    def prog(t):
        return _estimates(program(t))

    eager = {}
    with torch.inference_mode():
        for name, fn in (("model", fwd), ("program", prog)):
            eager[name] = [fn(x).cpu() for _ in range(2)]
    graphs = {}
    host = x.cpu().numpy()
    for name, fn in (("model", fwd), ("program", prog)):
        p = Program(fn, batch, T, torch.device(device))
        graphs[name] = [torch.from_numpy(np.array(p(host)))
                        for _ in range(2)]
        del p
    rec = {
        "program_vs_model_eager_db": snr_db(eager["model"][0],
                                            eager["program"][0]),
        "model_rerun_eager_db": snr_db(*eager["model"]),
        "program_rerun_eager_db": snr_db(*eager["program"]),
        "program_vs_model_graph_db": snr_db(graphs["model"][0],
                                            graphs["program"][0]),
        "model_graph_vs_eager_db": snr_db(eager["model"][0],
                                          graphs["model"][0]),
        "model_replay_rerun_db": snr_db(*graphs["model"]),
    }
    a, b = _logged(fwd, x), _logged(prog, x)
    k = first_difference(a, b)
    rec.update(ops=[len(a), len(b)], first_difference=k)
    if k is not None:
        rec["at"] = {"index": k, "model": a[k], "program": b[k]}
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--blocks", type=int, default=CFG["num_blocks"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the record as JSON")
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = args.deterministic
    card = card_line() if args.device == "cuda" else "cpu"
    rec = {"card": card, "dtype": args.dtype,
           "deterministic": args.deterministic, "blocks": args.blocks,
           "batch": args.batch, "seconds": args.seconds,
           **run(getattr(torch, args.dtype), args.blocks, args.batch,
                 args.seconds, args.device)}
    if "at" in rec:
        at = rec["at"]
        print(f"first differing op, #{at['index']} of {rec['ops'][0]}:")
        for side in ("model", "program"):
            name, checksum, operands = at[side]
            print(f"  {side}: {name} sum {checksum!r} on {operands}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
