"""Build the hand-written CUDA kernels of ``csrc/`` and load them with ctypes.

Each library is one ``nvcc`` call over one ``.cu`` file with a plain C
interface (no PyTorch headers, so a build takes seconds), compiled for
``sm_90a``.  The output lands in ``nsynth_wavenet_tpu_torch/_build/`` (listed
in .gitignore) under a name that carries a hash of every source and of the
flags, so an edited source is rebuilt on its next use.  Nothing is built or
loaded at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
# library name -> its translation unit (headers in csrc/ are hashed with every unit)
LIBRARIES = {"fastgen_kernel": "fastgen_kernel.cu", "flow_kernel": "flow_kernel.cu"}
# library name -> the constants it is compiled with (-D flags); the host-side
# launch plan of its ops module reads them from here, so the two share one set.
# flow_kernel: consumer warps of a persistent block, consumer groups, and rows
# of a tile (one 16-row band a warp of a group); the wide kernel's rows of a
# tile (one 64-row wgmma band a warpgroup of the same consumer warps) and
# K columns of a chunk of a bf16 operand.
DEFINES = {"flow_kernel": {"FLOW_WARPS": 8, "FLOW_GROUPS": 2, "FLOW_TILE_ROWS": 16 * 8 // 2,
                           "FLOW_WIDE_TILE_ROWS": 64 * 8 // 4, "FLOW_WIDE_KC": 64}}
# The perf probes of each library (ops/fastgen_kernel.py generate(probe=),
# ops/flow_kernel.py flow_stack(probe=)): library "<library>_<probe>" is the
# library's source compiled with -DKERNEL_PROBE=<code> (its Probe / FlowProbe
# enum: 1 + the index here), every kernel in that probe's variant, so the
# serving libraries hold no probe code.  Only a probe call loads one.
PROBES = {"fastgen_kernel": ("cheap_gate", "no_ring_write"), "flow_kernel": ("no_gate", "no_slide")}
LIBRARIES.update({f"{lib}_{probe}": LIBRARIES[lib] for lib, probes in PROBES.items() for probe in probes})
DEFINES.update({f"{lib}_{probe}": {**DEFINES.get(lib, {}), "KERNEL_PROBE": code}
                for lib, probes in PROBES.items() for code, probe in enumerate(probes, 1)})
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def defines(name: str) -> list:
    return [f"-D{k}={v}" for k, v in DEFINES.get(name, {}).items()]


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines(name)).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        if p.suffix == ".cuh" or p.name == LIBRARIES[name]:
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_of(name: str, probe=None) -> str:
    """The library that holds ``name``'s kernels in ``probe``'s variant (None
    or "": the serving library itself)."""
    if not probe:
        return name
    if probe not in PROBES.get(name, ()):
        raise ValueError(f"{name} has no probe {probe!r}: want one of {PROBES.get(name, ())}")
    return f"{name}_{probe}"


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(names=None):
    """Compile every missing library, one nvcc per source, all at once.
    Returns {name: (path, ptxas report)}; raises with nvcc's output on failure."""
    names = list(LIBRARIES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *defines(name), "-o", str(tmp), str(CSRC / LIBRARIES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports = {name: (library_path(name), "") for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = (out, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib

