"""Build and load the port's CUDA kernels.

Each of ``maunet_tpu_torch/csrc/*.cu`` compiles with its own ``nvcc``
process, all started together, and the objects link into one shared library
with a plain C interface, loaded with ``ctypes``.  Nothing includes
PyTorch's headers, so the build takes seconds.  The library lands in
``build/maunet_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so an unchanged tree loads the library it built before.

Nothing here runs at import: the first kernel launch builds the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "maunet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):   # sources and the .cuh they include
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmaunet_kernels_{digest.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with every failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the sources unless a library for them exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, cmds = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            cmds.append([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj])
        _run(cmds)
        lib = os.path.join(tmp, out.name)
        _run([[nvcc, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)  # atomic: concurrent builds agree on one file
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.maunet_error_string.argtypes = [ctypes.c_int]
    lib.maunet_error_string.restype = ctypes.c_char_p
    return lib


_FUNCTIONS: dict[tuple, ctypes._CFuncPtr] = {}


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name`` with its argument types declared, looked
    up once.  Every entry point returns a cudaError_t as an int."""
    key = (name, *argtypes)
    fn = _FUNCTIONS.get(key)
    if fn is None:
        fn = getattr(_library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[key] = fn
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        msg = _library().maunet_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(what: str, name: str, argtypes: list, t: torch.Tensor, *args) -> None:
    """Call the C entry point ``name`` (``argtypes`` as for :func:`function`,
    the stream last) with ``args`` and the current stream of ``t``'s device,
    with that device made current for the call: the entry points read the
    SM count and the shared-memory opt-in of the runtime's current device,
    and launch on it.  A model replica on ``cuda:1`` then runs there.
    Raises on a CUDA error."""
    with torch.cuda.device(t.get_device()):   # -1, a CPU tensor: no device
        check(function(name, argtypes)(*args, stream_of(t)), what)


def on_cpu(t: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (the wrapper then runs the plain version), False
    for a CUDA tensor (the wrapper launches the kernel); any other device
    raises.  There is no fallback from CUDA to the plain version."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{what}: no kernel for device {t.device}")


def require(cond: bool, what: str, msg) -> None:
    """Raise ValueError("what: msg") unless ``cond``; ``msg`` may be a
    function that formats the message, called only then."""
    if not cond:
        raise ValueError(f"{what}: {msg() if callable(msg) else msg}")


def require_no_grad(what: str, *tensors: torch.Tensor | None) -> None:
    """A kernel launch returns tensors without a ``grad_fn``.  Refuse one that
    would silently cut a gradient: grad enabled and an input that needs one,
    outside the autograd ``Function`` (if any) that wraps the kernel."""
    require(not (torch.is_grad_enabled()
                 and any(t is not None and t.requires_grad for t in tensors)),
            what, "an input needs a gradient and this kernel has no backward "
            "here; call it under torch.no_grad() or through its autograd Function")
