"""ctypes binding to the native C++ ``.npz`` decoder (``native/npz_loader.cpp``).

The port's copy of ``maunet_tpu/data/native.py``: the same API and errors
(``available``, ``load_npz``, ``load_batch``; ``IOError`` for a bad file or
a missing entry, ``RuntimeError`` when the decoder is unavailable).  The
source is built at first use, never at import, with ``g++ ... -lz
-lpthread`` into ``build/maunet_tpu_torch/libnpz_native_<hash>.so`` at the
repository root, named by a hash of the source and flags.  The build runs in
a temporary directory and lands with ``os.replace``, so processes that build
at once agree on one file.  ``available()`` is False where no compiler or
zlib is present (logged once); callers then read with numpy.

The batch API decodes many files on a C++ thread pool with the GIL
released.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from maunet_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "npz_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "maunet_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-lz", "-lpthread")


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnpz_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless a library for it exists; return its path.
    Raises ``FileNotFoundError`` without the source or ``g++``, and
    ``subprocess.CalledProcessError`` when the compile fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, out.name)
        subprocess.run(["g++", *CXX_FLAGS, "-o", lib, str(SOURCE), *LIBS],
                       check=True, capture_output=True, text=True, timeout=120)
        os.replace(lib, out)   # atomic: concurrent builds agree on one file
    return out


@functools.cache
def _library() -> ctypes.CDLL | None:
    try:
        lib = ctypes.CDLL(str(build()))
    except subprocess.CalledProcessError as e:
        log.warning(f"native npz loader build failed: {e}\n{e.stderr}")
        return None
    except (OSError, subprocess.SubprocessError) as e:
        log.warning(f"native npz loader unavailable: {e}")
        return None
    lib.npz_open.restype = ctypes.c_void_p
    lib.npz_open.argtypes = [ctypes.c_char_p]
    lib.npz_close.restype = None
    lib.npz_close.argtypes = [ctypes.c_void_p]
    lib.npz_last_error.restype = ctypes.c_char_p
    lib.npz_last_error.argtypes = []
    lib.npz_num_entries.restype = ctypes.c_int
    lib.npz_num_entries.argtypes = [ctypes.c_void_p]
    lib.npz_entry_name.restype = ctypes.c_char_p
    lib.npz_entry_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.npz_read_batch.restype = ctypes.c_int
    lib.npz_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int, ctypes.c_int]
    lib.npz_entry_usize.restype = ctypes.c_longlong
    lib.npz_entry_usize.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.npz_read_full.restype = ctypes.c_longlong
    lib.npz_read_full.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p, ctypes.c_longlong]
    log.info(f"native npz loader ready: {lib._name}")
    return lib


def available() -> bool:
    return _library() is not None


def _require() -> ctypes.CDLL:
    lib = _library()
    if lib is None:
        raise RuntimeError("native npz loader unavailable")
    return lib


def load_npz(path: str, names: list[str] | None = None) -> dict[str, np.ndarray]:
    """Decode one ``.npz`` file -> {name: array}, every entry or ``names``."""
    lib = _require()
    handle = lib.npz_open(path.encode())
    if not handle:
        raise IOError(f"npz_open({path}): {lib.npz_last_error().decode()}")
    try:
        if names is None:
            names = [lib.npz_entry_name(handle, i).decode().removesuffix(".npy")
                     for i in range(lib.npz_num_entries(handle))]
        out = {}
        for name in names:
            cap = lib.npz_entry_usize(handle, name.encode())
            if cap < 0:
                raise IOError(f"{path}:{name}: {lib.npz_last_error().decode()}")
            buf = np.empty(cap, np.uint8)
            dtype_buf = ctypes.create_string_buffer(16)
            shape_buf = (ctypes.c_longlong * 8)()
            ndim = ctypes.c_int()
            # One inflate per entry: header and payload together.
            nbytes = lib.npz_read_full(
                handle, name.encode(), dtype_buf, shape_buf, ctypes.byref(ndim),
                buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_longlong(cap))
            if nbytes < 0:
                raise IOError(f"{path}:{name}: {lib.npz_last_error().decode()}")
            shape = tuple(shape_buf[i] for i in range(ndim.value))
            out[name] = buf[:nbytes].view(np.dtype(dtype_buf.value.decode())).reshape(shape)
        return out
    finally:
        lib.npz_close(handle)


def load_batch(paths: list[str], name: str, shape: tuple[int, ...],
               dtype=np.float32, threads: int | None = None) -> np.ndarray:
    """Decode entry ``name`` (one fixed shape in every file) from many files
    on a C++ thread pool -> a (len(paths), *shape) array."""
    lib = _require()
    n = len(paths)
    out = np.empty((n, *shape), dtype=dtype)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_outs = (ctypes.c_void_p * n)(*[out[i].ctypes.data for i in range(n)])
    per = int(np.prod(shape)) * out.itemsize
    c_sizes = (ctypes.c_longlong * n)(*([per] * n))
    threads = threads or min(os.cpu_count() or 4, n)
    failures = lib.npz_read_batch(c_paths, name.encode(), c_outs, c_sizes, n, threads)
    if failures:
        raise IOError(f"native batch decode: {failures}/{n} files failed "
                      f"({lib.npz_last_error().decode()})")
    return out
