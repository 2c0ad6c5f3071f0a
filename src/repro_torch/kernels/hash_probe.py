"""The hand-written CUDA lookup kernel: build, bind, launch.

``fused_lookup_tiles`` is the port of the TPU kernel
``repro/kernels/hash_probe.py::fused_lookup_tiles``: fused multi-segment
probe + chain walk over a Snapshot, in one launch for any number of
segments (kernels/csrc/fused_lookup.cu says what it computes and what
bounds it).  Its plain PyTorch version is ``ref.fused_lookup_ref``.

The source (shipped as package data) is compiled by ``nvcc`` for
``sm_90a`` on first use into ``build/`` beside this module, which must be
writable, and bound through ``ctypes`` with a plain C interface.  A failed
build or launch raises; nothing here falls back to the plain version.  The kernel launches on PyTorch's current
stream and does not synchronize.

``LAUNCHES`` counts launches of the kernel: a plain integer that run
reports read to show that a path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_lookup.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES = 0
_LIB = None
BUILD_INFO: dict = {}   # path, seconds and compiler log of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}; the "
                           f"lookup kernel is built from {SOURCE}")
    return str(path)


def build() -> Path:
    """Compile the kernel (once per source content) and return the shared
    library's path.  The file name carries a hash of the source, so an
    edited source is rebuilt and a stale library is never loaded."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libfused_lookup_{tag[:16]}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{SOURCE}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), seconds=seconds,
                      log=(proc.stdout + proc.stderr).strip())
    return out


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.fused_lookup_launch.argtypes = [
            ctypes.c_int,                       # device
            ctypes.c_void_p, ctypes.c_longlong,  # query, num_queries
            ctypes.c_void_p, ctypes.c_int,      # segs, num_segments
            ctypes.c_int,                       # slots
            ctypes.c_void_p, ctypes.c_longlong,  # prev, capacity
            ctypes.c_void_p, ctypes.c_int,      # fill, max_matches
            ctypes.c_void_p, ctypes.c_void_p,   # rows, last
            ctypes.c_void_p]                    # stream
        lib.fused_lookup_launch.restype = ctypes.c_int
        lib.fused_lookup_error_string.argtypes = [ctypes.c_int]
        lib.fused_lookup_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _descriptor(snap):
    """The device array of (keys plane, ptrs plane, bucket count) triples
    the kernel walks, and the slot count.  Built and checked once per
    Snapshot version and cached on it, so a repeated lookup copies nothing
    from the host."""
    if snap.kernel_desc is not None:
        return snap.kernel_desc
    dev = snap.prev.device
    slots = snap.blocks[0].keys.shape[1]
    triples = []
    for i, blk in enumerate(snap.blocks):
        nb = blk.num_buckets
        if nb <= 0 or nb & (nb - 1):
            raise ValueError(f"block {i}: bucket count {nb} is not 2**k")
        for name, t, dt in (("keys", blk.keys, torch.int64),
                            ("ptrs", blk.ptrs, torch.int32)):
            if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                    or tuple(t.shape) != (nb, slots)):
                raise ValueError(
                    f"block {i} {name}: need a contiguous {dt} [{nb}, "
                    f"{slots}] tensor on {dev}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
        triples += [blk.keys.data_ptr(), blk.ptrs.data_ptr(), nb]
    desc = torch.tensor(triples, dtype=torch.int64).to(dev)
    object.__setattr__(snap, "kernel_desc", (desc, slots))
    return snap.kernel_desc


def fused_lookup_tiles(keys: torch.Tensor, snap, *, max_matches: int):
    """Fused probe + chain walk of ``keys [Q] int64`` over ``snap`` on the
    card.  Returns ``(rows [Q, max_matches] int32 newest-first NULL-padded,
    last [Q] int32)``, exactly as ``ref.fused_lookup_ref``."""
    global LAUNCHES
    if not keys.is_cuda:
        raise ValueError("fused_lookup_tiles runs on CUDA tensors; "
                         "ref.fused_lookup_ref is the CPU version")
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"keys must be 1-D int64, got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if max_matches < 1:
        raise ValueError(f"max_matches must be >= 1, got {max_matches}")
    dev = keys.device
    prev, fill = snap.prev, snap.fill
    if (prev.device != dev or prev.dtype != torch.int32 or prev.dim() != 1
            or not prev.is_contiguous()):
        raise ValueError("snapshot prev must be a contiguous 1-D int32 "
                         f"tensor on {dev}")
    if fill.device != dev or fill.dtype != torch.int32 or fill.numel() != 1:
        raise ValueError(f"snapshot fill must be one int32 on {dev}")
    desc, slots = _descriptor(snap)
    keys = keys.contiguous()
    q = keys.shape[0]
    rows = torch.empty((q, max_matches), dtype=torch.int32, device=dev)
    last = torch.empty((q,), dtype=torch.int32, device=dev)
    if q == 0:
        return rows, last
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_lookup_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        keys.data_ptr(), q, desc.data_ptr(), len(snap.blocks), slots,
        prev.data_ptr(), prev.shape[0], fill.data_ptr(), max_matches,
        rows.data_ptr(), last.data_ptr(), stream)
    if rc != 0:
        msg = lib.fused_lookup_error_string(rc).decode()
        raise RuntimeError(f"fused_lookup kernel launch failed: {msg} "
                           f"(CUDA error {rc})")
    LAUNCHES += 1
    return rows, last
