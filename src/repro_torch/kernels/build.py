"""Builds the port's hand-written CUDA kernels and loads them with ``ctypes``.

Each source under ``kernels/*/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface.  Libraries go
to ``build/repro_torch_kernels/`` at the root of the checkout, named by a
digest of every source under the library's ``csrc/`` directory (``.cu`` and
``.cuh``) and of nvcc's flags, so an edited source or header is rebuilt and
an unchanged library is loaded as it is.  Nothing is built at import time: the
first CUDA launch (or ``build_all``) builds what is missing, with one
``nvcc`` process per source, all started together.

A failed build raises ``RuntimeError`` carrying nvcc's stderr; there is no
fallback to the plain torch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent  # src/repro_torch/kernels
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch_kernels"

# library name -> the CUDA source nvcc compiles
SOURCES = {
    "bitset_ops": _PKG / "bitset_ops" / "csrc" / "degrees.cu",
    "expand_stats": _PKG / "bitset_ops" / "csrc" / "expand_stats.cu",
    "vc_expand": _PKG / "bitset_ops" / "csrc" / "vc_expand.cu",
    "clique_expand": _PKG / "bitset_ops" / "csrc" / "clique_expand.cu",
    "flash_attention": _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "flash_attention_wgmma": _PKG / "flash_attention" / "csrc" / "flash_attention_wgmma.cu",
    "wkv6": _PKG / "wkv6" / "csrc" / "wkv6.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)

# name -> nvcc's output of the build that made the library in this process
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str) -> str:
    """The path of the CUDA toolkit's program ``name`` (nvcc, cuobjdump)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            f"cannot run {name}: no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH)"
        )
    return os.path.join(CUDA_HOME, "bin", name)


def digest_inputs(name: str) -> list[Path]:
    """The files a library's digest covers: every ``.cu`` and ``.cuh`` under
    its source's directory, which its source may include."""
    csrc = SOURCES[name].parent
    return sorted(p for p in csrc.rglob("*") if p.suffix in (".cu", ".cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, SOURCES[name].name)).encode())
    for path in digest_inputs(name):
        h.update(f"\0{path.relative_to(SOURCES[name].parent)}\0".encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, concurrently.

    Returns ``BUILD_LOG`` (nvcc's output per library built here).  Raises
    ``RuntimeError`` with nvcc's stderr if any build fails, after every
    started process has exited.
    """
    running = {}
    for name in names if names is not None else SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        running[name] = (proc, tmp, out)
    failures = []
    for name, (proc, tmp, out) in running.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(
                f"nvcc failed for {name} (exit {proc.returncode}):\n{stderr}"
            )
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        BUILD_LOG[name] = stdout + stderr
    if failures:
        raise RuntimeError("\n".join(failures))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
