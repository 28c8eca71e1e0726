"""The port imports nothing of JAX or of the JAX package.

Checked in a fresh interpreter, because this test process already imported
jax through tests/conftest.py."""

import os
import pkgutil
import subprocess
import sys

import nsynth_wavenet_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "nsynth_wavenet_tpu", "tools", "benchmarks", "flax", "optax", "orbax")


def _port_modules():
    names = ["nsynth_wavenet_tpu_torch"]
    for info in pkgutil.walk_packages(nsynth_wavenet_tpu_torch.__path__, "nsynth_wavenet_tpu_torch."):
        names.append(info.name)
    return names


def test_port_and_chip_smoke_import_no_jax():
    modules = _port_modules() + ["chip_smoke", "eval_wavenet_torch", "eval_parallel_wavenet_torch",
                                 "train_wavenet_torch", "train_parallel_wavenet_torch",
                                 "build_dataset_torch"]
    assert "nsynth_wavenet_tpu_torch.ops.fastgen_kernel" in modules
    assert "nsynth_wavenet_tpu_torch.kernels.build" in modules
    assert "nsynth_wavenet_tpu_torch.ops.flow_kernel" in modules
    assert "nsynth_wavenet_tpu_torch.models.parallelgen" in modules
    for name in ("training.optimizer", "training.train_lib", "training.checkpoint",
                 "training.runner", "data.dataset", "data.synthetic", "utils.logging_utils",
                 "utils.tree", "models.parallel_wavenet", "ops.stft", "utils.quality",
                 "data.native.native", "parallel.mesh", "tools.quality_smoke",
                 "tools.longform_check", "tools.make_golden_ckpt", "tools.make_golden_wavs",
                 "tools.make_eval_model", "tools.downsample", "tools.gather_results"):
        assert f"nsynth_wavenet_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FORBIDDEN []" in proc.stdout

