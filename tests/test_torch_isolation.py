"""The port stands alone: importing every ``repro_torch`` module loads
neither JAX nor the JAX package, and its entry points refuse to run on
the CPU unless the caller asks for it."""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch.mesh import Mesh, make_mesh

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0].startswith("jax")
                or m == "repro" or m.startswith("repro."))
print(len(names), leaked)
assert not leaked, leaked
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 34


def test_mesh_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default mesh is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 1), ("data", "model"), device="cuda")


def test_mesh_shape_and_ranks():
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    x = torch.arange(4.0)
    assert mesh.ppermute(x, ("data", "model"), [(0, 0)]) is x
    assert torch.equal(mesh.ppermute(x, "model", []), torch.zeros(4))
    with pytest.raises(NotImplementedError, match="A3"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError):
        Mesh((1,), ("data", "model"), torch.device("cpu"))


def test_multiply_refuses_operands_off_the_mesh_device():
    from repro_torch.core.cannon import cannon_matmul

    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    a = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="mesh"):
        cannon_matmul(a, a, mesh=mesh)
