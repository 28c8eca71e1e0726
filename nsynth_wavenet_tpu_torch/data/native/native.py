"""ctypes binding of the native crop gather (sampler.cpp).

``load`` builds the library with g++ at first use into
``nsynth_wavenet_tpu_torch/_build/`` (listed in .gitignore) under a name that
carries a hash of the source and the flags, as kernels/build.py names the
CUDA libraries, and loads it.  It returns None where no compiler is found or
the build fails; Dataset then gathers in numpy, which gives the same bits.
Nothing is built or loaded at import time.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from nsynth_wavenet_tpu_torch.kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "sampler.cpp"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_lock = threading.Lock()
_state = {"tried": False, "lib": None}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsampler-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """g++ into a per-process temporary file renamed into place, so that
    concurrent processes never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def load():
    """The loaded library, built first if needed; None when it cannot be built."""
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.crop_gather.argtypes = [_f32p, _i64p, _i64p, ctypes.c_int64, _i64p, _i64p,
                                    ctypes.c_int64, ctypes.c_int64, _f32p, ctypes.c_int64]
        lib.crop_gather.restype = None
        _state["lib"] = lib
        return lib


def crop_gather(data, offsets, lengths, rec_idx, starts, crop_len, out,
                n_threads: int = 0) -> bool:
    """out[b] = data[offsets[r] + starts[b] : + crop_len] for r = rec_idx[b],
    zero-padded past the record's end (a row whose record index is out of
    range is all zeros).  False when the library is unavailable (the caller
    gathers in numpy).  data and out: C-contiguous float32; offsets, lengths,
    rec_idx and starts: C-contiguous int64; out [len(rec_idx), crop_len]."""
    lib = load()
    if lib is None:
        return False
    for name, a, dtype in (("data", data, np.float32), ("out", out, np.float32),
                           ("offsets", offsets, np.int64), ("lengths", lengths, np.int64),
                           ("rec_idx", rec_idx, np.int64), ("starts", starts, np.int64)):
        if a.dtype != dtype or not a.flags.c_contiguous:
            raise TypeError(f"crop_gather: {name} must be C-contiguous {np.dtype(dtype)}, got "
                            f"{a.dtype}, contiguous={a.flags.c_contiguous}")
    if len(offsets) != len(lengths) or len(starts) != len(rec_idx):
        raise ValueError("crop_gather: offsets / lengths or rec_idx / starts differ in length")
    if out.shape != (len(rec_idx), crop_len):
        raise ValueError(f"crop_gather: out shape {out.shape} != {(len(rec_idx), crop_len)}")
    lib.crop_gather(data.ctypes.data_as(_f32p), offsets.ctypes.data_as(_i64p),
                    lengths.ctypes.data_as(_i64p), ctypes.c_int64(len(offsets)),
                    rec_idx.ctypes.data_as(_i64p), starts.ctypes.data_as(_i64p),
                    ctypes.c_int64(len(rec_idx)), ctypes.c_int64(crop_len),
                    out.ctypes.data_as(_f32p), ctypes.c_int64(n_threads))
    return True
