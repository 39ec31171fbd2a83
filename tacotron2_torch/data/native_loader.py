"""ctypes bindings for the native (C++) batch WAV loader.

The port's own binding of ``native/wavio.cc``: decode WAV, PCM -> float,
downmix, reflect-pad and pack padded batches in a C++ thread pool, outside
the GIL.  The source is read by path from its one place in the repository
and compiled on first use by ``g++`` with ``native/build.sh``'s flags into
``tacotron2_torch/_build/libt2x_wavio-<hash>.so`` (the hash covers the
source and the flags, so an edited source rebuilds).  Each build writes a
temporary name and ``os.replace``-s it into place, so processes that build
at once never load a half-written library.  Same functions, signatures and
return layouts as ``tacotron2_tpu/data/native_loader.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "wavio.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# native/build.sh's flags
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-pthread")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libt2x_wavio-{digest[:12]}.so"


def build() -> Path:
    """Compile ``native/wavio.cc`` unless it is built.  Raises when there
    is no source or no ``g++``, or the compile fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native WAV loader needs it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exit {proc.returncode} building {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_library() -> Optional[ctypes.CDLL]:
    """Load (building on demand) the native library; None if unavailable."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        print(f"native WAV loader unavailable: {e}")
        return None
    lib.t2x_decode_wav.restype = ctypes.c_int64
    lib.t2x_decode_wav.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.t2x_decode_batch.restype = None
    lib.t2x_decode_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32]
    _lib = lib
    return _lib


def native_available() -> bool:
    return get_library() is not None


def decode_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode one WAV with the native decoder. Raises if unavailable.

    The scratch buffer starts at half the file's byte size (exact for the
    common PCM16-mono case, 2-8x oversized for multi-channel/32-bit); if
    the decoder reports it too small (8-bit mono files), it retries once
    with the exact size -- truncation cannot occur (the C side returns
    ``-needed`` instead of clamping)."""
    lib = get_library()
    if lib is None:
        raise RuntimeError("native loader not available")
    size = os.path.getsize(path) if os.path.isfile(path) else 0
    max_samples = max(size // 2, 64)
    rate = ctypes.c_int32(0)
    for _ in range(2):
        out = np.empty(max_samples, np.float32)
        n = lib.t2x_decode_wav(
            path.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_samples, ctypes.byref(rate))
        if n > 0:
            return out[:n].copy(), int(rate.value)
        if n < 0:
            max_samples = -n
            continue
        break
    raise IOError(f"native WAV decode failed: {path}")


def decode_batch_padded(paths: Sequence[str], pad: int, total_len: int,
                        n_threads: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Threaded decode of many WAVs into one reflect-padded batch.

    Returns (batch (N, total_len) float32, lengths (N,) int64 [0 = failed
    or didn't fit], rates (N,) int32).  Rows are reflect-padded by ``pad``
    on both sides (librosa center=True semantics) and zero-padded to
    ``total_len`` -- exactly the layout
    :func:`tacotron2_torch.dsp.mel.batched_log_mel_with_lengths` expects.
    """
    lib = get_library()
    if lib is None:
        raise RuntimeError("native loader not available")
    enc = [p.encode() for p in paths]
    offsets = np.zeros(len(enc), np.int64)
    pos = 0
    blob_parts: List[bytes] = []
    for i, e in enumerate(enc):
        offsets[i] = pos
        blob_parts.append(e + b"\0")
        pos += len(e) + 1
    blob = b"".join(blob_parts)

    n = len(paths)
    out = np.zeros((n, total_len), np.float32)
    lengths = np.zeros(n, np.int64)
    rates = np.zeros(n, np.int32)
    lib.t2x_decode_batch(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pad, total_len, n_threads)
    return out, lengths, rates
