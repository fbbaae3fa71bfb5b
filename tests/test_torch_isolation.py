"""The PyTorch port stands alone: no JAX, no reference package, no silent
CPU fallback."""
import dataclasses
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
    assert n >= 70  # every ported module was imported


def test_new_runtime_modules_import_no_jax_and_no_reference():
    """The scheduler, fault tolerance and workers stand alone: each imported
    on its own pulls in neither JAX nor the reference package."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("repro_torch.core.scheduler",
                     "repro_torch.runtime.fault_tolerance",
                     "repro_torch.runtime.workers",
                     "repro_torch.core.calibration",
                     "repro_torch.launch.serve",
                     "repro_torch.optim.optimizers",
                     "repro_torch.distribution.steps",
                     "repro_torch.launch.train",
                     "repro_torch.examples.lm_pretrain",
                     "repro_torch.examples.lm_federation",
                     "repro_torch.kernels.ssd_scan.ops",
                     "repro_torch.models.mamba2",
                     "repro_torch.models.hybrid"):
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        print("BAD", bad)
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True).stdout
    assert "BAD []" in out, out


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "import jax" not in src and "from repro." not in src
    assert "from repro " not in src and "import repro\n" not in src


def _entry_points():
    from repro_torch import resolve_device
    from repro_torch.configs.registry import get_config
    from repro_torch.core.devicemodel import GRADES
    from repro_torch.core.serving import ContinuousBatchingEngine, init_arena
    from repro_torch.core.simulation import DeviceTier, LogicalTier
    from repro_torch.core.updates import UpdateBuffer
    from repro_torch.launch.serve import BatchedServer, stack_requests
    from repro_torch.examples import federated_ctr, quickstart
    from repro_torch.models import ctr, encdec, hybrid, mamba2, transformer
    from repro_torch.runtime.workers import FleetWorkerPool, WorkerSpec
    from repro_torch.distribution.steps import init_train_state
    from repro_torch.launch import train

    fn = ctr.make_local_train_fn()
    lm = get_config("llama3_2_3b", smoke=True)
    ssm = get_config("mamba2_1_3b", smoke=True)
    hyb = get_config("zamba2_1_2b", smoke=True)
    moe = get_config("granite_moe_3b_a800m", smoke=True)
    audio = get_config("seamless_m4t_medium", smoke=True)
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
        "transformer.init": lambda: transformer.init(0, lm),
        "transformer.init_cache": lambda: transformer.init_cache(lm, 1, 4),
        "transformer.params_from_numpy": lambda: transformer.params_from_numpy(
            {"ln_f": np.ones(4, np.float32), "layers": []},
            dataclasses.replace(lm, scan_layers=False)),
        "mamba2.init": lambda: mamba2.init(0, ssm),
        "mamba2.init_cache": lambda: mamba2.init_cache(ssm, 1),
        "mamba2.params_from_numpy": lambda: mamba2.params_from_numpy(
            {"ln_f": np.ones(4, np.float32), "layers": []},
            dataclasses.replace(ssm, scan_layers=False)),
        "hybrid.init": lambda: hybrid.init(0, hyb),
        "hybrid.init_cache": lambda: hybrid.init_cache(hyb, 1, 4),
        "transformer.init[moe]": lambda: transformer.init(0, moe),
        "encdec.init": lambda: encdec.init(0, audio),
        "encdec.init_cache": lambda: encdec.init_cache(audio, 1, 4, 3),
        "encdec.params_from_numpy": lambda: encdec.params_from_numpy(
            {"ln_f": np.ones(4, np.float32), "encoder": [], "decoder": []},
            dataclasses.replace(audio, scan_layers=False)),
        "quickstart.run": lambda: quickstart.run(),
        "federated_ctr.run": lambda: federated_ctr.run(devices=2, rounds=1),
        "init_arena": lambda: init_arena(lm, 2, 4),
        "ContinuousBatchingEngine": lambda: ContinuousBatchingEngine(
            lm, slots=2, prompt_len=4, decode_tokens=2),
        "BatchedServer": lambda: BatchedServer(
            lm, batch_size=2, prompt_len=4, decode_tokens=2, max_len=7),
        "stack_requests": lambda: stack_requests(np.ones((2, 4))),
        "FleetWorkerPool": lambda: FleetWorkerPool(WorkerSpec(print), 2),
        "init_train_state": lambda: init_train_state(lm),
        "train.main[cloud]": lambda: train.main(
            ["--mode", "cloud", "--smoke", "--steps", "1"]),
        "train.main[federated]": lambda: train.main(["--smoke"]),
        "train.main[tasks]": lambda: train.main(["--smoke", "--tasks", "2"]),
    }


@pytest.mark.parametrize("name", sorted([
    "resolve_device", "lr_init", "mlp_init", "params_from_numpy",
    "LogicalTier", "DeviceTier", "UpdateBuffer.from_state_dict",
    "transformer.init", "transformer.init_cache",
    "transformer.params_from_numpy", "mamba2.init", "mamba2.init_cache",
    "mamba2.params_from_numpy", "hybrid.init", "hybrid.init_cache",
    "transformer.init[moe]", "encdec.init", "encdec.init_cache",
    "encdec.params_from_numpy", "quickstart.run", "federated_ctr.run",
    "init_arena",
    "ContinuousBatchingEngine", "BatchedServer", "stack_requests",
    "FleetWorkerPool", "init_train_state", "train.main[cloud]",
    "train.main[federated]", "train.main[tasks]"]))
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


def test_kernel_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """On CPU tensors "auto" runs the plain versions and counts no launch;
    an explicit request for the kernel raises instead of falling back."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    q = torch.randn(1, 8, 2, 16)
    lens = torch.tensor([5], dtype=torch.int32)
    d0, f0 = decode_attention.launches, flash_attention.launches
    decode_attention(q[:, 0], q, q, lens)
    flash_attention(q, q, q)
    assert (decode_attention.launches, flash_attention.launches) == (d0, f0)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q[:, 0], q, q, lens, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q, impl="cuda")
    x, dt, A, B = q, torch.rand(1, 8, 2), -torch.ones(2), q[:, :, :1]
    s0 = ssd_scan.launches
    ssd_scan(x, dt, A, B, B, chunk=4)
    assert ssd_scan.launches == s0
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(x, dt, A, B, B, chunk=4, impl="cuda")


def test_ssd_scan_backward_takes_the_plain_version_only_for_cpu_tensors():
    """A backward through ``ssd_scan`` on CPU tensors runs the plain
    backward and counts no launch; the CUDA backward refuses CPU
    tensors."""
    from repro_torch.kernels.ssd_scan import ops

    x = torch.randn(1, 8, 2, 4, requires_grad=True)
    dt, A = torch.rand(1, 8, 2), -torch.ones(2)
    B = torch.randn(1, 8, 1, 3)
    b0 = ops.ssd_scan.bwd_launches
    y, _ = ops.ssd_scan(x, dt, A, B, B, chunk=4)
    y.sum().backward()
    assert ops.ssd_scan.bwd_launches == b0 and x.grad is not None
    with pytest.raises(ValueError, match="CUDA"):
        ops._ssd_scan_bwd_cuda(x.detach(), dt, A, B, B,
                               torch.ones(1, 8, 2, 4), None, 4)


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
