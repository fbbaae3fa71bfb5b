"""The PyTorch port stands alone: no JAX, no reference package, no silent
CPU fallback."""
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def test_import_loads_no_jax_and_no_reference_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        print("MODULES", len(names))
        print("BAD", bad)
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True).stdout
    assert "BAD []" in out, out
    n = int(out.split("MODULES ")[1].split()[0])
    assert n >= 20  # every ported module was imported


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "import jax" not in src and "from repro." not in src
    assert "from repro " not in src and "import repro\n" not in src


def _entry_points():
    from repro_torch import resolve_device
    from repro_torch.core.devicemodel import GRADES
    from repro_torch.core.simulation import DeviceTier, LogicalTier
    from repro_torch.core.updates import UpdateBuffer
    from repro_torch.models import ctr

    fn = ctr.make_local_train_fn()
    buf = UpdateBuffer.from_stacked({"w": torch.ones(2, 3)})
    state = buf.state_dict()
    state["device"] = "cuda"
    return {
        "resolve_device": lambda: resolve_device(),
        "lr_init": lambda: ctr.lr_init(4),
        "mlp_init": lambda: ctr.mlp_init(4, 2),
        "params_from_numpy": lambda: ctr.params_from_numpy(
            {"w": np.zeros(4, np.float32), "b": np.float32(0)}),
        "LogicalTier": lambda: LogicalTier(fn),
        "DeviceTier": lambda: DeviceTier(fn, GRADES["High"]),
        "UpdateBuffer.from_state_dict": lambda: UpdateBuffer.from_state_dict(
            state),
    }


@pytest.mark.parametrize("name", sorted([
    "resolve_device", "lr_init", "mlp_init", "params_from_numpy",
    "LogicalTier", "DeviceTier", "UpdateBuffer.from_state_dict"]))
def test_entry_point_defaults_to_cuda_and_raises_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_entry_points_run_on_cpu_when_asked():
    from repro_torch.models import ctr

    p = ctr.lr_init(4, device="cpu")
    assert p["w"].device.type == "cpu" and p["b"].shape == ()
    back = ctr.params_to_numpy(ctr.params_from_numpy(
        {"w": np.arange(4, dtype=np.float32), "b": np.float32(2)}, "cpu"))
    np.testing.assert_array_equal(back["w"], np.arange(4, dtype=np.float32))
    assert back["b"].shape == () and back["b"] == 2


def test_fed_reduce_kernel_refuses_cpu_tensors():
    from repro_torch.kernels.fed_reduce.ops import fed_reduce

    with pytest.raises(ValueError, match="CUDA"):
        fed_reduce(torch.ones(3, 2), torch.ones(3), impl="cuda")


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
