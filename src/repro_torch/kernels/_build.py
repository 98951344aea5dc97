"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each source compiles at first use, with one ``nvcc`` per source and all of
them started together, into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<hash>/lib<name>.so
         csrc/<name>.cu

``<hash>`` digests every file under ``csrc/`` and the flags, so an edited
source never loads a stale library.  The libraries are loaded with
``ctypes``: pointers and the stream pass as ``c_void_p``, and each C entry
returns ``cudaGetLastError()`` after its launches, which the wrapper turns
into an exception.  A failed build raises with nvcc's stderr; nothing here
falls back to another path.  ``-Xptxas -v`` (registers, shared memory,
spills per kernel) goes to ``<name>.log`` beside the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("checksum", "flash_attention", "mamba2_ssd", "rwkv6_wkv",
           "swiglu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                       "the Hopper kernels build only where the CUDA "
                       "toolkit is installed")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, all nvcc
    processes at once.  Returns {name: seconds} for what was built."""
    names = list(names)
    unknown = sorted(set(names) - set(SOURCES))
    if unknown:
        raise ValueError(f"unknown kernel sources {unknown}; "
                         f"known: {SOURCES}")
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        target = out_dir / f"lib{name}.so"
        if target.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, target, time.perf_counter())
    seconds: Dict[str, float] = {}
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        stdout, stderr = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (out_dir / f"{name}.log").write_text(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str, prototypes: Mapping[str, Sequence]) -> ctypes.CDLL:
    """The loaded library for ``name`` (built first if missing), with
    ``argtypes`` set from ``prototypes`` and ``restype`` c_int."""
    lib = _LIBS.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in prototypes.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, rc: int):
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: cuda error "
                           f"{rc} ({msg})")


# ------------------------------------------------------ launch helpers
FAULT_KINDS = {"stuck": 0, "dropped_mac": 1, "gain": 2}
_MASKS: Dict[Tuple[object, torch.device], torch.Tensor] = {}


def lane_fault_args(fault, out_width: int, device: torch.device
                    ) -> Tuple[int, Optional[torch.Tensor], float, float]:
    """(kind code, device lane bitmask, value, gain) for a kernel's fault
    epilogue.  Kind -1 selects the healthy instantiation: no fault, or an
    output whose lane width is not the fault's (``LaneFault.apply`` leaves
    such tensors alone)."""
    if fault is None or out_width != fault.width:
        return -1, None, 0.0, 0.0
    key = (fault, device)
    mask = _MASKS.get(key)
    if mask is None:
        words = np.zeros((fault.width + 31) // 32, np.uint32)
        for lane in fault.lanes:
            words[lane >> 5] |= np.uint32(1) << np.uint32(lane & 31)
        mask = torch.from_numpy(words.view(np.int32)).to(device)
        _MASKS[key] = mask
    return FAULT_KINDS[fault.kind], mask, float(fault.value), \
        float(fault.gain)


def require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)
