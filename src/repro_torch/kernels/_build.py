"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), under
``build/repro_torch/`` at the root of the checkout.  A library's file name
carries a digest of its sources and flags, so an edited source is rebuilt
and a stale library is never loaded.  Sources build in parallel, one
``nvcc`` each.  Nothing is built when a module is imported: the first
kernel launch builds what it needs.

Run ``python -m repro_torch.kernels._build`` to build every source with
``-Xptxas -v`` and print each kernel's registers, shared memory and spills.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("conv_block", "xnor_matmul", "megakernel")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float        # 0.0 when an up-to-date library was reused
    log: str              # nvcc's stderr (the -Xptxas -v report, if asked)


def nvcc() -> str:
    """The toolkit's nvcc, found the way PyTorch's own builder finds it."""
    from torch.utils import cpp_extension
    if cpp_extension.CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    path = Path(cpp_extension.CUDA_HOME) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path}")
    return str(path)


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES,
          ptxas_verbose: bool = False) -> Dict[str, Built]:
    """Compile the named sources, all ``nvcc`` processes started together.

    An up-to-date library is reused unless ``ptxas_verbose`` asks for the
    compiler's report, which needs a fresh compile.  Raises with nvcc's
    output if any source fails to build.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    built: Dict[str, Built] = {}
    t0 = time.perf_counter()
    for name in names:
        out = _library_path(name)
        if out.exists() and not ptxas_verbose:
            built[name] = Built(name, out, 0.0, "")
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        built[name] = Built(name, out, time.perf_counter() - t0,
                            stdout + stderr)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return built


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    return ctypes.CDLL(str(build((name,))[name].path))


if __name__ == "__main__":
    for b in build(ptxas_verbose=True).values():
        print(f"== {b.name}: built in {b.seconds:.1f} s -> {b.path.name}")
        print(b.log.strip())
