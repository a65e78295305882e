"""Build the hand-written CUDA kernels of `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain `extern "C"` launcher, so it compiles
with nvcc alone (no PyTorch headers, no ninja) into
`grasptrajopt_tpu_torch/_build/lib<name>.so` at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

_loaded: Dict[str, ctypes.CDLL] = {}


@dataclass
class BuildResult:
    library: Path
    command: List[str]
    log: str  # nvcc's output, including the -Xptxas -v register report


def nvcc_executable() -> str:
    root = os.environ.get("CUDA_HOME")
    if root and (Path(root) / "bin" / "nvcc").exists():
        return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def build(name: str, force: bool = False) -> BuildResult:
    """Compile csrc/<name>.cu for sm_90a unless an up-to-date library exists."""
    src = CSRC_DIR / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    if not force and lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return BuildResult(lib, [], "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = [
        nvcc_executable(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), str(src),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    _loaded.pop(name, None)
    return BuildResult(lib, cmd, log)


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed;
    `declare` sets the functions' argtypes / restype once, on first load."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build(name).library))
        declare(lib)
        _loaded[name] = lib
    return _loaded[name]
