"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers that decided ``correct``, each with
its limit.  The run fails, and prints no result, without CUDA or with fewer
cards than the cell asks for, or if JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One host thread for the CPU side of numpy and torch: an idle pool of
# intra-op threads spins on the shared host and slows the one thread that
# dispatches to the card.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def keep_freed_memory() -> bool:
    """Have glibc serve large blocks from the heap and keep what is freed,
    so that each click's tens of MB of numpy temporaries are not mapped,
    faulted in and unmapped again by the kernel, whose cost swings with the
    host's load.  False where the C library is not glibc."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return False
    libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    m_trim_threshold, m_top_pad, m_mmap_threshold = -1, -2, -3
    return all(libc.mallopt(opt, value) == 1 for opt, value in (
        (m_mmap_threshold, 1 << 30), (m_trim_threshold, 2**31 - 1), (m_top_pad, 1 << 28)))


MALLOC_KEPT = keep_freed_memory()
ROOT = Path(__file__).resolve().parents[1]
# Every build and kernel cache at a fixed path inside the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    torch.set_num_threads(1)

    cell = harness.find(ROOT, args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    result, lines = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                     bool(args.trace), torch.device("cuda", 0), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print(f"detail malloc_kept {MALLOC_KEPT}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
