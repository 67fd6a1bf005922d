"""Deployment bundles (counterpart of ``tdanet_tpu/deploy.py``): serving
programs traced with ``torch.export``, saved beside the weights and served
without the model code.

    bundle/
      meta.json       model name and args, sample rate, lattice, buckets,
                      devices, torch version, the kernel libraries a CUDA
                      program calls
      params.npz      flat torch-named weights (fp32 numpy), the names of
                      the JAX package's bundle
      programs/T<target>_B<batch>.<device>.pt2

A serving host loads a bundle with :func:`load_bundle` and never imports
``tdanet_tpu_torch.models``: no registry, no model classes, no tracing.
A program is the same per-utterance forward the port's engines run
(``model(x, per_utterance=True)``: every row as if alone), so a bundle's
output is the one ``utils.separator.separate_batched`` gives.

Kernel #1 stays a kernel inside the artifact: the port's ConvNorm sites
call ``torch.ops.tdanet_tpu_torch.dw_conv_glob_ln`` (registered by
``kernels/dw_conv_glob_ln.py``), which the tracer keeps as one node a site.
A program exported for the card launches the CUDA kernel at each of them
when it runs; the serving host builds the kernel's library from the
package's ``csrc/`` at first use, and a bundle whose recorded source hash
differs from the installed source is refused. A program runs only on the
device it was exported for: ``devices`` (default ``("cuda",)``) writes one
file per device, and :func:`load_bundle` on a host without a card raises.

On the card each length bucket runs as one CUDA graph
(``serving.Program``), the counterpart of the JAX loader's one ``jit`` per
bucket; the progressive stage pair is captured the same way.

Weights: the programs keep them as parameters (``model.<name>``), and
:func:`load_bundle` copies ``params.npz`` (or ``params_npz``, e.g. one
the JAX package wrote for the same architecture) into them before the
first run, so one bundle is re-weighted without export.

Length routing is lattice-exact by default, as in the JAX package: the
GlobLN statistics run over the padded tensor, so an utterance runs in
the program of its own lattice round-up, and anything else raises;
``coarse=True`` routes to the next bucket up (an approximation).

From the JAX package's arguments, ``platforms`` became ``devices`` and
``jax_version`` ``torch_version``; ``load_streaming`` has no ``dw_fold``
(the port has no TPU lowering to choose, ``serving.py``).
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Any, Dict, Sequence

import numpy as np
import torch
from torch import nn

from tdanet_tpu_torch.kernels import _build
from tdanet_tpu_torch.kernels.dw_conv_glob_ln import OP
from tdanet_tpu_torch.progressive import progressive_loop
from tdanet_tpu_torch.serving import (MultiStreamSeparator, Program,
                                      _estimates, capture, capture_stream,
                                      pool_handle)
from tdanet_tpu_torch.utils.separator import depth_kw, trim_renorm

_FORMAT_VERSION = 1
# a program's parameters are its model's, under the wrapper's attribute
PREFIX = "model."
# stage 1's state as its program returns it; stage 2 reads the first three
STATE = ("mixture", "carry", "enc", "delta")


def _flatten(state) -> Dict[str, np.ndarray]:
    """A model's ``state_dict()`` (or any flat ``{name: tensor}``) as the
    flat fp32 numpy dict of ``params.npz``."""
    return {k: v.detach().to(torch.float32).cpu().numpy()
            for k, v in state.items()}


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``params.npz``'s arrays as a torch state dict."""
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _dtype(compute_dtype):
    """None, a torch dtype, or its name ("bfloat16") -> None or the
    dtype."""
    if compute_dtype is None or isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    dtype = getattr(torch, str(compute_dtype), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute dtype {compute_dtype!r}")
    return dtype


def _on(model, device):
    """The model on ``device``: itself when it is there, else a copy."""
    now = next(model.parameters()).device
    if now.type == device.type and device.index in (None, now.index):
        return model
    return copy.deepcopy(model).to(device)


class _Forward(nn.Module):
    """(B, T) float32 -> (B, n_src, T), every row as if alone."""

    def __init__(self, model, compute_dtype, num_blocks):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype
        self.depth = depth_kw(num_blocks)

    def forward(self, x):
        return self.model(x, per_utterance=True,
                          compute_dtype=self.compute_dtype, **self.depth)


class _Stage1(nn.Module):
    """(B, T) float32 -> (est, {mixture, carry, enc, delta}) at depth1."""

    def __init__(self, model, depth1, compute_dtype):
        super().__init__()
        self.model = model
        self.depth1 = depth1
        self.compute_dtype = compute_dtype

    def forward(self, x):
        est, state = self.model.forward_stage1(
            x, self.depth1, per_utterance=True,
            compute_dtype=self.compute_dtype)
        return est, {k: state[k] for k in STATE}


class _Stage2(nn.Module):
    """(mixture, carry, enc) of stage 1 -> the estimates n_more
    iterations on."""

    def __init__(self, model, depth1, n_more, rest):
        super().__init__()
        self.model = model
        self.depth1, self.n_more, self.rest = depth1, n_more, rest

    def forward(self, mixture, carry, enc):
        state = {"mixture": mixture, "carry": carry, "enc": enc,
                 "depth": self.depth1}
        return self.model.forward_stage2(state, self.n_more, self.rest,
                                         per_utterance=True)


def _export(module, args):
    with torch.no_grad():
        return torch.export.export(module.eval(), args, strict=False)


def export_forward(model, target_len: int, batch_size: int = 8,
                   compute_dtype=None, num_blocks=None, device="cuda"):
    """Export one serving program, (batch, target_len) float32 on
    ``device`` -> (batch, n_src, target_len), every row as if alone, in
    ``compute_dtype`` (a torch dtype or its name; None: the model's).
    Returns a ``torch.export.ExportedProgram``."""
    device = torch.device(device)
    x = torch.zeros((batch_size, target_len), dtype=torch.float32,
                    device=device)
    return _export(_Forward(_on(model, device), _dtype(compute_dtype),
                            num_blocks), (x,))


def _progressive_depth(model, depth1, depth_full):
    """The stage pair's full depth, checked as
    ``progressive.separate_progressive`` checks it."""
    if not hasattr(model, "forward_stage1"):
        raise TypeError(
            f"progressive export needs a model with the staged forward "
            f"(forward_stage1/forward_stage2/pad_rest); "
            f"{type(model).__name__} has none")
    depth_full = depth_full if depth_full is not None else model.num_blocks
    if depth_full > model.num_blocks:
        # a stage-2 program must not run the shared-weight recurrence past
        # the trained depth
        raise ValueError(
            f"depth_full ({depth_full}) exceeds the trained depth "
            f"({model.num_blocks})")
    if depth_full <= depth1:
        raise ValueError(f"depth_full ({depth_full}) must exceed "
                         f"depth1 ({depth1})")
    return depth_full


def export_progressive(model, target_len: int, batch_size: int, depth1: int,
                       depth_full=None, compute_dtype=None, device="cuda"):
    """Export the progressive (adaptive-depth) stage pair for one padded
    length: stage 1 ``x (batch, T) -> (est, state)`` at ``depth1`` and
    stage 2 ``(mixture, carry, enc) -> est`` continuing to
    ``depth_full``, the pair ``progressive.separate_progressive`` runs.
    Stage 2's example inputs are stage 1's outputs, so the two agree on
    the state."""
    depth_full = _progressive_depth(model, depth1, depth_full)
    device = torch.device(device)
    model = _on(model, device)
    compute_dtype = _dtype(compute_dtype)
    x = torch.zeros((batch_size, target_len), dtype=torch.float32,
                    device=device)
    e1 = _export(_Stage1(model, depth1, compute_dtype), (x,))
    state = _outputs(e1)[1]
    example = tuple(torch.zeros(state[k].shape, dtype=state[k].dtype,
                                device=device) for k in STATE[:3])
    e2 = _export(_Stage2(model, depth1, depth_full - depth1,
                         model.pad_rest(target_len)), example)
    return e1, e2


def op_nodes(program) -> int:
    """The nodes of kernel #1's op in an exported program or its
    module."""
    graph = program.graph
    return sum(1 for n in graph.nodes if n.target is OP)


def _kernels(program) -> Dict[str, Dict[str, str]]:
    """The CUDA libraries a program calls, each by its library's name and
    its source hash (``kernels/_build.py``)."""
    if not op_nodes(program):
        return {}
    name = "dw_conv_glob_ln"
    return {name: {"library": _build.library_path(name).name,
                   "source_hash": _build.source_hash(name)}}


def _outputs(program):
    """The outputs of an exported program or of its loaded module as the
    tracer saw them (fake tensors), in the structure the program
    returns."""
    out = next(n for n in program.graph.nodes if n.op == "output").args[0]
    sig = getattr(program, "graph_signature", None)
    if sig is None:  # a loaded module returns its user outputs alone
        spec = program._out_spec
    else:
        out = out[len(out) - len(sig.user_outputs):]
        spec = program.call_spec.out_spec
    return torch.utils._pytree.tree_unflatten([a.meta["val"] for a in out],
                                              spec)


def _n_src(program) -> int:
    """The sources of a program (or its module): its estimates, the
    output or the first of its outputs, are (batch, n_src, T)."""
    est = _outputs(program)
    return int((est[0] if isinstance(est, tuple) else est).shape[1])


def save_bundle(path: str, model, lengths: Sequence[float] = (),
                batch_size: int = 8, compute_dtype=None, num_blocks=None,
                devices: Sequence[str] = ("cuda",),
                streaming: dict | None = None,
                early_exit: Sequence[int] = (),
                progressive: dict | None = None):
    """Export a deployment bundle to directory ``path``.

    ``lengths``: utterance lengths in SECONDS; each is padded up to the
    model's stride lattice and becomes one program (duplicates collapse).

    ``devices``: one file per program and device, ``<name>.<device>.pt2``
    (the model is copied to each device to be traced there).

    ``streaming``: also a live-streaming program, ``dict(segment=sec,
    max_streams=N, overlap=0.25, emit_dtype="float32")``, exported at
    exactly ``segment * sr`` samples and ``max_streams`` rows, so
    :func:`load_streaming` reproduces ``serving.MultiStreamSeparator``.

    ``early_exit``: further depths to export each bucket at, files
    ``E<depth>_T<target>_B<batch>``; ``load_bundle(num_blocks=d)``
    serves them.

    ``progressive``: the adaptive-depth stage pair per bucket,
    ``dict(depth1=8, depth_full=None, threshold=0.05)``, files
    ``P<target>_B<batch>_s1`` / ``_s2``; :func:`load_progressive` serves
    them with ``progressive.progressive_loop``.

    Returns the meta written to ``meta.json``; its ``programs`` entry
    gives each file's export seconds and bytes."""
    sr = model.sample_rate()
    lattice = getattr(model, "lcm", 1)
    targets = sorted({-(-int(round(s * sr)) // lattice) * lattice
                      for s in lengths})
    if not targets and streaming is None:
        raise ValueError("save_bundle needs lengths and/or streaming")
    full_depth = getattr(model, "num_blocks", None)
    for d in early_exit:
        if full_depth is not None and not 0 < d < full_depth:
            raise ValueError(f"early_exit depth {d} must lie in "
                             f"(0, {full_depth}) for this model")
    if early_exit and not targets:
        # programs are per (depth, bucket): meta would advertise depths
        # with no program
        raise ValueError("early_exit export needs lengths")
    if progressive is not None:
        if not targets:
            raise ValueError("progressive export needs lengths")
        depth1 = int(progressive["depth1"])
        depth_full = _progressive_depth(model, depth1,
                                        progressive.get("depth_full"))
    devices = [torch.device(d) for d in devices]
    os.makedirs(os.path.join(path, "programs"), exist_ok=True)
    np.savez(os.path.join(path, "params.npz"),
             **_flatten(model.state_dict()))

    records: Dict[str, Dict[str, float]] = {}
    kernels: Dict[str, Dict[str, str]] = {}
    n_src = None

    def save(name, device, export):
        """Export (one program, or the stage pair), save, record."""
        t0 = time.perf_counter()
        programs = export()
        seconds = time.perf_counter() - t0
        tagged = zip(("_s1", "_s2"), programs) \
            if isinstance(programs, tuple) else (("", programs),)
        for tag, ep in tagged:
            fname = f"{name}{tag}.{device.type}.pt2"
            fpath = os.path.join(path, "programs", fname)
            ep.example_inputs = None  # zeros the tracer needed, not a server
            torch.export.save(ep, fpath)
            records[fname] = {"export_s": seconds,
                              "bytes": os.path.getsize(fpath)}
            if device.type == "cuda":
                kernels.update(_kernels(ep))
        return programs

    kw = dict(compute_dtype=compute_dtype)
    for device in devices:
        m = _on(model, device)
        for target in targets:
            save(f"T{target}_B{batch_size}", device,
                 lambda: export_forward(m, target, batch_size,
                                        num_blocks=num_blocks,
                                        device=device, **kw))
            for d in early_exit:
                save(f"E{d}_T{target}_B{batch_size}", device,
                     lambda: export_forward(m, target, batch_size,
                                            num_blocks=d, device=device,
                                            **kw))
            if progressive is not None:
                save(f"P{target}_B{batch_size}", device,
                     lambda: export_progressive(
                         m, target, batch_size, depth1=depth1,
                         depth_full=depth_full, device=device, **kw))
        if streaming is not None:
            seg_len = int(round(float(streaming["segment"]) * sr))
            n_streams = int(streaming.get("max_streams", 4))
            ep = save(f"S{seg_len}_B{n_streams}", device,
                      lambda: export_forward(m, seg_len, n_streams,
                                             num_blocks=num_blocks,
                                             device=device, **kw))
            n_src = _n_src(ep)
        del m

    meta = {
        "format_version": _FORMAT_VERSION,
        "model_name": type(model).__name__,
        "model_args": model.get_model_args(),
        "sample_rate": sr,
        "lattice": lattice,
        "batch_size": batch_size,
        "targets": targets,
        "compute_dtype": (None if compute_dtype is None
                          else str(_dtype(compute_dtype)).split(".")[-1]),
        "num_blocks": num_blocks,
        "devices": [d.type for d in devices],
        "torch_version": str(torch.__version__),
        "kernels": kernels,
        "programs": records,
    }
    if early_exit:
        meta["early_exit"] = sorted(int(d) for d in early_exit)
    if progressive is not None:
        meta["progressive"] = {
            "depth1": depth1,
            "depth_full": depth_full,
            "threshold": float(progressive.get("threshold", 0.05)),
        }
    if streaming is not None:
        meta["streaming"] = {
            "segment": float(streaming["segment"]),
            "seg_len": seg_len,
            "max_streams": n_streams,
            "overlap": float(streaming.get("overlap", 0.25)),
            "emit_dtype": streaming.get("emit_dtype", "float32"),
            "n_src": n_src,
        }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def _pad_rows(t, rows):
    n = t.shape[0]
    if n == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - n, *t.shape[1:]))])


class _Graphed:
    """A loaded program of ``rows`` rows, called on up to ``rows``: the
    missing rows are zeros (every row runs as if alone), and the first
    ``n`` rows of every output come back as tensors of their own. On the
    card the program is one CUDA graph over static inputs shaped like
    ``example`` (a tuple of tensors); on the CPU it runs eagerly."""

    def __init__(self, module, example, device, pool=None, stream=None):
        self.module, self.rows = module, example[0].shape[0]
        self.graph = None
        if device.type == "cuda":
            self.graph, self.inputs, self.out = capture(
                module, lambda: tuple(torch.zeros_like(t) for t in example),
                device, pool, stream)

    def __call__(self, *xs):
        n = xs[0].shape[0]
        with torch.inference_mode():
            if self.graph is None:
                out = self.module(*(_pad_rows(x, self.rows) for x in xs))
            else:
                for static, x in zip(self.inputs, xs):
                    static[:n].copy_(x)
                    static[n:].zero_()
                self.graph.replay()
                out = self.out
            return torch.utils._pytree.tree_map(lambda t: t[:n].clone(),
                                                out)


def _bucket(T: int, targets: Sequence[int], lattice: int,
            coarse: bool) -> int:
    """The bucket of ``targets`` (sorted) that an utterance of T samples
    runs in: its lattice round-up, or with ``coarse`` the next bucket up;
    anything else raises."""
    exact = -(-T // lattice) * lattice
    if exact in targets:
        return exact
    if coarse:
        for target in targets:
            if target >= T:
                return target
        raise ValueError(
            f"utterance of {T} samples exceeds every exported bucket "
            f"{list(targets)}; re-export the bundle with a longer length")
    raise ValueError(
        f"utterance of {T} samples needs the lattice-exact program "
        f"T={exact} but the bundle exports {list(targets)}; re-export "
        "with this length, or load_bundle(..., coarse=True) to accept "
        "next-bucket-up padding (approximate: the extra pad shifts the "
        "GlobLN statistics)")


class DeployedSeparator:
    """Runs a deployment bundle's bucket programs. Holds no model code:
    the loaded programs (``modules``, {target: module}) and the bundle's
    meta. Mirrors ``utils.separator.separate_batched``'s trim and
    renormalisation. Each bucket's program becomes a ``serving.Program``
    at its first use: on the card one CUDA graph, all in one pool."""

    def __init__(self, meta: Dict[str, Any], modules: Dict[int, nn.Module],
                 device, coarse: bool = False):
        self.meta = meta
        self.modules = modules
        self.device = torch.device(device)
        self.sample_rate = meta["sample_rate"]
        self.batch_size = meta["batch_size"]
        self.lattice = meta["lattice"]
        self.coarse = coarse
        self.targets = sorted(modules)
        self.programs: Dict[int, Program] = {}
        self._pool = pool_handle(self.device)
        self._stream = capture_stream(self.device)

    def _program(self, target: int) -> Program:
        if target not in self.programs:
            module = self.modules[target]
            self.programs[target] = Program(
                lambda x: _estimates(module(x)), self.batch_size, target,
                self.device, pool=self._pool, stream=self._stream)
        return self.programs[target]

    def separate(self, wav: np.ndarray) -> np.ndarray:
        """(T,) -> (n_src, T), trimmed and energy-renormalised."""
        return self.separate_batched([np.asarray(wav)])[0]

    def separate_batched(self, wavs) -> list:
        """Variable-length utterances -> per-utterance (n_src, T_i)
        estimates (input order), bucketed over the exported programs."""
        buckets: Dict[int, list] = {}
        for i, w in enumerate(wavs):
            buckets.setdefault(
                _bucket(int(np.asarray(w).shape[-1]), self.targets,
                        self.lattice, self.coarse), []).append(i)
        outputs = [None] * len(wavs)
        B = self.batch_size
        for target, idxs in sorted(buckets.items()):
            program = self._program(target)
            for s in range(0, len(idxs), B):
                chunk = idxs[s:s + B]
                batch = np.zeros((B, target), np.float32)
                for row, i in enumerate(chunk):
                    w = np.asarray(wavs[i], np.float32)
                    batch[row, :w.shape[-1]] = w
                est = program(batch)
                for row, i in enumerate(chunk):
                    mix = np.asarray(wavs[i], np.float32)
                    outputs[i] = trim_renorm(mix, est[row])
        return outputs


def _load_meta(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    pdir = os.path.join(path, "programs")
    names = os.listdir(pdir) if os.path.isdir(pdir) else []
    if "devices" not in meta or (any(n.endswith(".shlo") for n in names)
                                 and not any(n.endswith(".pt2")
                                             for n in names)):
        raise ValueError(
            f"bundle at {path} was written by the JAX package (StableHLO "
            f".shlo programs for {meta.get('platforms')}); it holds no "
            f"torch program. Export one with python -m "
            f"tdanet_tpu_torch.export_bundle (its params.npz re-weights "
            f"a bundle of the same model: load_bundle(..., params_npz=))")
    if meta.get("format_version", 0) > _FORMAT_VERSION:
        raise ValueError(
            f"bundle format {meta['format_version']} is newer than this "
            f"loader ({_FORMAT_VERSION})")
    return meta


def _device_for(meta: Dict[str, Any], path: str, device):
    """The device to serve on: one the bundle has programs for; a card
    that exists; kernel sources that hash as they did at export."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA is not available: the bundle's CUDA programs run only on "
            f"a card (it has programs for {meta['devices']})")
    if device.type not in meta["devices"]:
        raise ValueError(
            f"bundle at {path} has programs for {meta['devices']}, not "
            f"{device.type}; re-export with --devices {device.type}")
    if device.type == "cuda":
        for name, rec in meta.get("kernels", {}).items():
            now = _build.source_hash(name)
            if now != rec["source_hash"]:
                raise RuntimeError(
                    f"bundle at {path} was traced against {rec['library']} "
                    f"(source hash {rec['source_hash']}) but the installed "
                    f"csrc/{name}.cu hashes {now}; re-export the bundle "
                    f"with this package")
    return device


def _weights(path: str, params_npz: str | None) -> Dict[str, torch.Tensor]:
    with np.load(params_npz or os.path.join(path, "params.npz")) as z:
        return _unflatten({k: z[k] for k in z.files})


def _load_program(fpath: str, device, weights: Dict[str, torch.Tensor]):
    """One program file as a module on ``device``, re-weighted from
    ``weights`` (every parameter, by name, or it raises)."""
    module = torch.export.load(fpath).module()
    params = dict(module.named_parameters())
    want = {PREFIX + k for k in weights}
    if set(params) != want:
        raise ValueError(
            f"the weights do not match {os.path.basename(fpath)}: missing "
            f"{sorted(set(params) - want)[:5]}, unexpected "
            f"{sorted(want - set(params))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            p.requires_grad_(False)
            p.copy_(weights[name[len(PREFIX):]])
    for t in (*module.parameters(), *module.buffers()):
        if t.device.type != device.type:
            raise RuntimeError(f"{fpath} holds a tensor on {t.device}, "
                               f"not {device.type}")
    return module


def _load_programs(path: str, prefix: str, device, weights,
                   suffix: str = ""):
    """``{target: module}`` for the files named
    ``<prefix><target>_B<batch><suffix>.<device>.pt2``."""
    programs = {}
    pdir = os.path.join(path, "programs")
    ext = f"{suffix}.{device.type}.pt2"
    for fname in sorted(os.listdir(pdir)):
        if not (fname.endswith(ext) and fname.startswith(prefix)):
            continue
        target = int(fname[len(prefix):].split("_")[0])
        programs[target] = _load_program(os.path.join(pdir, fname), device,
                                         weights)
    return programs


def load_bundle(path: str, params_npz: str | None = None,
                coarse: bool = False, num_blocks: int | None = None,
                device="cuda") -> DeployedSeparator:
    """Load a bundle saved by :func:`save_bundle` to serve on ``device``
    (its programs for that device alone). ``params_npz`` swaps in other
    weights of the same model without export; ``coarse`` routes an
    utterance to the next-larger bucket when its lattice-exact program is
    missing (approximate); ``num_blocks`` serves an early-exit depth
    exported with ``save_bundle(..., early_exit=[...])``."""
    meta = _load_meta(path)
    device = _device_for(meta, path, device)
    weights = _weights(path, params_npz)
    if num_blocks is None:
        # T* = the full-depth buckets; S*/E*/P* are the streaming,
        # early-exit and progressive programs
        programs = _load_programs(path, "T", device, weights)
        if not programs:
            raise ValueError(
                f"no batched programs/T*.{device.type}.pt2 found under "
                f"{path} (a streaming-only bundle serves via "
                f"load_streaming)")
    else:
        if num_blocks not in meta.get("early_exit", []):
            raise ValueError(
                f"bundle at {path} exports early-exit depths "
                f"{meta.get('early_exit', [])}, not {num_blocks}; "
                "re-export with save_bundle(..., early_exit=[...])")
        programs = _load_programs(path, f"E{num_blocks}_T", device, weights)
        if not programs:
            raise ValueError(
                f"no early-exit programs/E{num_blocks}_T*.{device.type}.pt2 "
                f"found under {path}")
    return DeployedSeparator(meta, programs, device, coarse=coarse)


class DeployedProgressiveSeparator:
    """Serves the adaptive-depth path from a bundle: the stage-1 sweep at
    depth1, the threshold census, the exact stage-2 continuation of the
    flagged utterances, through ``progressive.progressive_loop``, the
    host orchestration ``separate_progressive`` runs, with the bundle's
    stage programs (``stages``, {target: (stage 1, stage 2)}). No model
    code. On the card each stage is one CUDA graph a bucket, made at the
    bucket's first use."""

    def __init__(self, meta: Dict[str, Any], stages: Dict[int, tuple],
                 device, coarse: bool = False):
        self.meta = meta
        self.stages = stages
        self.device = torch.device(device)
        self.sample_rate = meta["sample_rate"]
        self.batch_size = meta["batch_size"]
        self.lattice = meta["lattice"]
        self.coarse = coarse
        self.depth1 = meta["progressive"]["depth1"]
        self.depth_full = meta["progressive"]["depth_full"]
        self.threshold = meta["progressive"]["threshold"]
        self.targets = sorted(stages)
        self.n_src = _n_src(stages[self.targets[0]][0])
        self.graphs: Dict[int, tuple] = {}
        self._pool = pool_handle(self.device)
        self._stream = capture_stream(self.device)

    def _fns(self, target: int):
        if target not in self.graphs:
            m1, m2 = self.stages[target]
            x = torch.zeros((self.batch_size, target), dtype=torch.float32,
                            device=self.device)
            g1 = _Graphed(m1, (x,), self.device, self._pool, self._stream)
            with torch.inference_mode():
                state = (g1.out if g1.graph is not None else m1(x))[1]
            g2 = _Graphed(m2, tuple(state[k] for k in STATE[:3]),
                          self.device, self._pool, self._stream)
            self.graphs[target] = (g1, g2)
        g1, g2 = self.graphs[target]
        return g1, lambda st: g2(*(st[k] for k in STATE[:3]))

    def separate(self, wav: np.ndarray, threshold=None):
        return self.separate_batched([np.asarray(wav)],
                                     threshold=threshold)[0]

    def separate_batched(self, wavs, threshold=None, stats=None) -> list:
        """Variable-length utterances -> per-utterance (n_src, T_i)
        estimates, adaptive depth per utterance. ``stats`` (optional
        dict) accumulates the escalation census across buckets."""
        threshold = self.threshold if threshold is None else threshold
        buckets: Dict[int, list] = {}
        for i, w in enumerate(wavs):
            buckets.setdefault(
                _bucket(int(np.asarray(w).shape[-1]), self.targets,
                        self.lattice, self.coarse), []).append(i)
        outputs = [None] * len(wavs)
        if stats is not None:
            stats.setdefault("n", 0)
            stats.setdefault("n_escalated", 0)
        for target, idxs in sorted(buckets.items()):
            fn1, fn2 = self._fns(target)
            mixes = np.zeros((len(idxs), target), np.float32)
            for row, i in enumerate(idxs):
                w = np.asarray(wavs[i], np.float32)
                mixes[row, :w.shape[-1]] = w
            ests, info = progressive_loop(
                fn1, fn2, mixes, self.batch_size, threshold, self.device,
                depth1=self.depth1, depth_full=self.depth_full)
            if stats is not None:
                stats["n"] += len(idxs)
                stats["n_escalated"] += info["n_escalated"]
            for row, i in enumerate(idxs):
                mix = np.asarray(wavs[i], np.float32)
                outputs[i] = trim_renorm(mix, ests[row])
        return outputs


def load_progressive(path: str, params_npz: str | None = None,
                     coarse: bool = False,
                     device="cuda") -> DeployedProgressiveSeparator:
    """The adaptive-depth separator of a bundle exported with
    ``progressive=dict(depth1=...)``, on ``device``."""
    meta = _load_meta(path)
    if "progressive" not in meta:
        raise ValueError(
            f"bundle at {path} has no progressive programs; re-export "
            "with save_bundle(..., progressive=dict(depth1=...))")
    device = _device_for(meta, path, device)
    weights = _weights(path, params_npz)
    s1 = _load_programs(path, "P", device, weights, suffix="_s1")
    s2 = _load_programs(path, "P", device, weights, suffix="_s2")
    if sorted(s1) != sorted(s2) or not s1:
        raise ValueError(f"incomplete progressive stage pairs under "
                         f"{path}: s1={sorted(s1)} s2={sorted(s2)}")
    return DeployedProgressiveSeparator(
        meta, {t: (s1[t], s2[t]) for t in s1}, device, coarse=coarse)


def load_streaming(path: str, params_npz: str | None = None,
                   overlap: float | None = None,
                   emit_dtype: str | None = None,
                   device="cuda") -> MultiStreamSeparator:
    """A live-streaming engine from a bundle exported with
    ``streaming=...``: a ``serving.MultiStreamSeparator`` whose forward is
    the bundle's program (on the card, captured as its CUDA graph), with
    the engine's stitching and no model code; the engine's ``module`` is
    the loaded program. ``overlap`` and ``emit_dtype`` default to the
    values recorded at export."""
    meta = _load_meta(path)
    sm = meta.get("streaming")
    if sm is None:
        raise ValueError(
            f"bundle at {path} has no streaming program; re-export with "
            "save_bundle(..., streaming=dict(segment=..., max_streams=...))")
    device = _device_for(meta, path, device)
    fname = os.path.join(
        path, "programs",
        f"S{sm['seg_len']}_B{sm['max_streams']}.{device.type}.pt2")
    module = _load_program(fname, device, _weights(path, params_npz))
    engine = MultiStreamSeparator(
        model=None, max_streams=sm["max_streams"], segment=sm["segment"],
        overlap=overlap if overlap is not None else sm["overlap"],
        sample_rate=meta["sample_rate"],
        emit_dtype=emit_dtype if emit_dtype is not None
        else sm["emit_dtype"],
        forward_fn=module, n_src=sm["n_src"], device=device)
    engine.module = module
    return engine
