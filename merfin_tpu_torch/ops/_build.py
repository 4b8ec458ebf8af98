"""Build, load and bind the port's CUDA kernels (nvcc -> shared library
-> ctypes).

Sources live in ``merfin_tpu_torch/csrc``; each is compiled for sm_90a at
first use into ``build/merfin_tpu_torch/`` at the repository root.  The
library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "merfin_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, spills) of each library built by this process
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "merfin_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, so)
    BUILD_LOGS[name] = proc.stderr
    return so


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib


def build_all(names) -> None:
    """Build several libraries at once, one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(build, n) for n in names]:
            f.result()


def raw_stream(device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device``, as an
    int: what torch.cuda.current_stream(device).cuda_stream gives,
    without building a Stream object on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


class Kernel:
    """One C entry point of a ``csrc`` library, bound with ctypes.

    Subclasses name the library (``lib``), the entry (``symbol``) and its
    ``argtypes``, and optionally an ``init`` entry (no arguments, returns
    a CUDA error code) run once before the first launch and a ``configs``
    entry that fills one int64 for each of ``config_keys`` with the
    library's built constants; ``launches`` counts the launches this
    wrapper made.  ``instances`` lists every wrapper made (the -trace
    file reports their launches)."""

    name = lib = symbol = source = replaces = ""
    init = configs = ""
    config_keys: tuple = ()
    argtypes: list = []
    instances: list = []

    def __init__(self):
        Kernel.instances.append(self)
        self.launches = 0
        self._fn = None
        self._config = None

    def config(self) -> dict:
        """The built constants, by ``config_keys``."""
        if self._config is None:
            fn = getattr(load(self.lib), self.configs)
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = None
            out = (ctypes.c_longlong * len(self.config_keys))()
            fn(ctypes.addressof(out))
            self._config = dict(zip(self.config_keys, out))
        return self._config

    def build(self):
        """Compile (if needed) and bind the kernel; returns the C entry."""
        if self._fn is None:
            lib = load(self.lib)
            if self.init:
                init = getattr(lib, self.init)
                init.argtypes = []
                init.restype = ctypes.c_int
                err = init()
                if err != 0:
                    raise RuntimeError(
                        f"{self.name}: {self.init} failed: CUDA error {err}")
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def check(self, q, *specs) -> None:
        """Raise unless every (tensor, dtype) of ``specs`` is a contiguous
        1-D tensor of that dtype on the CUDA device of ``q``."""
        dev = q.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name} kernel takes CUDA tensors")
        for t, dt in specs:
            if t.device != dev or t.dtype != dt or t.dim() != 1 \
                    or not t.is_contiguous():
                raise ValueError(
                    f"{self.name}: expected contiguous 1-D {dt} on {dev}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}")

    def launch(self, *args) -> None:
        fn = self.build()
        err = fn(*args)
        self.launches += 1
        if err != 0:
            raise RuntimeError(
                f"{self.name} launch failed: CUDA error {err}")
