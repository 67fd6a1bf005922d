"""Start the ranks of a data-parallel run (counterpart of
``scripts/launch_multihost.py``): every rank gets torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``) and runs the same command, which calls
``parallel.initialize_distributed``.

    # N local ranks, one a card (cuda:LOCAL_RANK, NCCL)
    python -m tdanet_tpu_torch.launch_multihost --nprocs 2 -- \\
        audio_train --conf_dir configs/tdanet.yml

    # N local ranks on the CPU (gloo); or every rank on one card over gloo
    python -m tdanet_tpu_torch.launch_multihost --nprocs 2 --cpu -- \\
        audio_train --conf_dir configs/tdanet_debug.yml
    python -m tdanet_tpu_torch.launch_multihost --nprocs 2 \\
        --device cuda:0 --backend gloo -- audio_train --conf_dir ...

``torchrun --nproc_per_node N -m tdanet_tpu_torch.audio_train ...`` starts
the same ranks, and the ranks of a job over several hosts. The command
after ``--`` is a module of this package (``audio_train``), ``-m module``
or a script path; ``--cpu`` and ``--device`` are passed to it as
``--device``. When a rank exits with an
error the others are stopped (they would wait in a collective for it),
and the launcher exits with that rank's code.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def child_command(cmd, device=None):
    """The rank's argv: a module of this package runs with ``python -m``;
    ``--device`` is appended when given."""
    if cmd[0] == "-m" or cmd[0].endswith(".py"):
        argv = [sys.executable] + cmd
    else:
        argv = [sys.executable, "-m", f"tdanet_tpu_torch.{cmd[0]}"] + cmd[1:]
    if device is not None:
        argv += ["--device", device]
    return argv


def rank_env(addr, port, world, rank, local, backend=None):
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, MASTER_ADDR=addr, MASTER_PORT=str(port),
               WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(local),
               PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    if backend:
        env["TDANET_DIST_BACKEND"] = backend
    return env


def wait_all(procs, timeout=None):
    """Wait for every rank; when one fails (or the time is up) stop the
    rest. Returns the first non-zero exit code, else 0."""
    start, failed = time.monotonic(), 0
    while any(p.poll() is None for p in procs):
        rcs = [p.poll() for p in procs]
        bad = [rc for rc in rcs if rc not in (None, 0)]
        late = timeout is not None and time.monotonic() - start > timeout
        if bad or late:
            failed = bad[0] if bad else 124
            break
        time.sleep(0.1)
    if failed:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        return failed
    return next((p.returncode for p in procs if p.returncode), 0)


def main(argv=None):
    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument("--nprocs", type=int, required=True,
                   help="start N local ranks")
    p.add_argument("--cpu", action="store_true",
                   help="every rank on the CPU, over gloo")
    p.add_argument("--device", default=None,
                   help="every rank on this device (cuda:0: the ranks share "
                        "one card, which needs --backend gloo)")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: NCCL for CUDA ranks, gloo for CPU ranks")
    p.add_argument("--timeout", type=float, default=None,
                   help="stop every rank after this many seconds (exit 124)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- audio_train args...")
    args = p.parse_args(argv)
    cmd = [c for c in args.cmd if c != "--"]
    if not cmd:
        p.error("no command given (use: -- audio_train ...)")
    if args.cpu and args.device not in (None, "cpu"):
        p.error("--cpu and --device name two devices")
    device = "cpu" if args.cpu else args.device
    backend = args.backend or ("gloo" if args.cpu else None)
    argv_child = child_command(cmd, device)

    port = free_port()
    procs = [subprocess.Popen(
        argv_child, cwd=os.getcwd(),
        env=rank_env("127.0.0.1", port, args.nprocs, r, r, backend))
        for r in range(args.nprocs)]
    return wait_all(procs, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
