"""The port stands alone: importing every ``repro_torch`` module loads
neither JAX nor the JAX package, and its entry points refuse to run on
the CPU unless the caller asks for it."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import Mesh, make_mesh

from torch_threads import one_thread  # noqa: F401

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
    assert n_modules >= 86


_IMPORT_PLANNER = r"""
import sys
import repro_torch.planner
from repro_torch.planner import calibrate, cost_model, plan
leaked = sorted(m for m in sys.modules
                if m.split(".")[0].startswith("jax")
                or m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert calibrate.DEFAULT_CALIBRATION.endswith("_h100.json")
print("ok")
"""


def test_importing_the_planner_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_PLANNER], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["ok"]


_BLOCKED_RUN = r"""
import importlib.abc, sys


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top.startswith("jax") or top == "repro":
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _Refuse())
import numpy as np
from repro_torch import obs, tensor
from repro_torch.core import dbcsr
from repro_torch.examples import tensor_contraction
from repro_torch.launch.mesh import make_mesh

mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
data, mask = tensor_contraction.build_integral_tensor(
    np.random.RandomState(0), 16, 32, 64)
B = dbcsr.create_tensor(data, mesh=mesh, block_sizes=(8, 16, 16),
                        block_mask=mask, compute_norms=True)
obs.enable()
C = tensor.contract("iaP,iaQ->PQ", B, B, mesh=mesh, filter_eps=1e-8)
obs.disable()
names = sorted({s.name for s in obs.last_trace()})
assert {"contract", "plan", "matricize", "multiply", "dispatch"} <= set(
    names), names
assert obs.validate_chrome_trace(obs.to_chrome_trace(obs.last_trace())) == []
print("ok", C.shape)
"""


def test_obs_tensor_and_example_run_with_jax_and_the_reference_blocked():
    """``repro_torch.obs``, ``repro_torch.tensor`` and the tensor example
    import and run a traced contraction while any import of jax or of
    the JAX package raises."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["ok", "(64,", "64)"]


_BLOCKED_LAUNCH = r"""
import importlib.abc, os, sys


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top.startswith("jax") or top == "repro":
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _Refuse())
env = dict(os.environ)
from repro_torch.launch import cost_counter, dryrun, roofline, specs
from repro_torch.configs.base import get_config, reduced_config
assert dict(os.environ) == env, "importing the launch tools set a variable"
rec = dryrun.run_cell("rwkv6_1_6b", "decode_32k",
                      cfg=reduced_config(get_config("rwkv6_1_6b")))
assert rec["status"] == "ok" and rec["hlo_costs"]["flops"] > 0
print("ok", rec["roofline"]["dominant"])
"""


def test_launch_tools_run_with_jax_and_the_reference_blocked():
    """``repro_torch.launch.{roofline,specs,cost_counter,dryrun}`` import
    (setting no environment variable, unlike the JAX dry-run) and count a
    cell while any import of jax or of the JAX package raises."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_LAUNCH], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["ok", "memory"]


def test_calibration_cli_measures_on_the_card_only(tmp_path, monkeypatch):
    """``python -m repro_torch.planner.calibrate`` measures on the CUDA
    device only: without a card it raises and writes no file."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    from repro_torch.planner import calibrate

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate.main([])
    assert not (tmp_path / calibrate.DEFAULT_CALIBRATION).exists()


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
    x = torch.arange(4.0).reshape(1, 4)   # the rank axis leads
    assert mesh.ppermute(x, ("data", "model"), [(0, 0)]) is x
    assert torch.equal(mesh.ppermute(x, "model", []), torch.zeros(1, 4))
    # multi-rank meshes simulate their ranks on the one device (they
    # raised naming A3 before the schedules were ported)
    for shape, axes in (((2, 2), ("data", "model")),
                        ((2, 4), ("data", "model")),
                        ((2, 2, 2), ("pod", "data", "model"))):
        mesh = make_mesh(shape, axes, device="cpu")
        assert mesh.n_ranks == int(np.prod(shape))
        assert mesh.shape == dict(zip(axes, shape))
        y = torch.arange(float(mesh.n_ranks)).reshape(-1, 1)
        assert torch.equal(mesh.axis_index(axes[-1]),
                           torch.arange(mesh.n_ranks) % shape[-1])
        left = mesh.ppermute(y, axes[-1], [(k, (k - 1) % shape[-1])
                                          for k in range(shape[-1])])
        assert torch.equal(left.flatten(), mesh.axis_index(axes[-1]).float()
                           .add(1).remainder(shape[-1])
                           + (y.flatten() - mesh.axis_index(axes[-1])))
    with pytest.raises(ValueError):
        Mesh((1,), ("data", "model"), torch.device("cpu"))
    with pytest.raises(ValueError, match="rank axis"):
        make_mesh((2, 2), ("data", "model"), device="cpu").psum(
            torch.zeros(3, 2), "data")


def test_multiply_refuses_operands_off_the_mesh_device():
    from repro_torch.core.cannon import cannon_matmul

    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    a = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="mesh"):
        cannon_matmul(a, a, mesh=mesh)
