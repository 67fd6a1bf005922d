"""The port stands alone: importing every module of tdanet_tpu_torch pulls
in neither JAX, nor the JAX package, nor yaml, none of which the GPU
machine has."""
import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tdanet_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "tdanet_tpu", "yaml", "optax", "orbax")


def _forbidden(name):
    root = name.split(".")[0]
    return root in FORBIDDEN


def test_importing_every_module_loads_no_jax_or_yaml():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tdanet_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'tdanet_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 10 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_module_of_the_port_imports_jax_or_yaml():
    found = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                found += [(path, n) for n in names if _forbidden(n)]
    assert not found, found
