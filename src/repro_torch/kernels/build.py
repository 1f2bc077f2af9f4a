"""Build the CUDA kernels under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds.  At first use every source is compiled,
all at once in parallel, into ``build/kernels/<name>-<hash>.so`` at the
root of the checkout; the hash covers the sources, the shared headers
and the flags, so an edit rebuilds and an unchanged tree reuses the
library.  A failed build raises with the compiler's output; a
successful one keeps it beside the library (``<name>-<hash>.log``), with
ptxas's register, shared-memory and spill counts of every kernel
(``ptxas_report``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every ``csrc/*.cu`` not yet built, one nvcc per source,
    all started together.  Returns {kernel name: library path}."""
    sources = sorted(CSRC.glob("*.cu"))
    targets = {src.stem: _target(src) for src in sources}
    todo = [src for src in sources if not targets[src.stem].exists()]
    if not todo:
        return targets
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{out}")
            os.unlink(tmp)
        else:
            targets[src.stem].with_suffix(".log").write_text(out)
            os.replace(tmp, targets[src.stem])
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return targets


def ptxas_report() -> Dict[str, dict]:
    """{kernel (mangled name): registers, spill bytes, shared memory, and
    ptxas's warnings (such as wgmma serialization)} from the build logs of
    the current sources."""
    report = {}
    for src in sorted(CSRC.glob("*.cu")):
        log = _target(src).with_suffix(".log")
        if not log.exists():
            continue
        kernel = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
                report[kernel] = {"source": src.name, "warnings": []}
                continue
            if kernel is None:
                continue
            if "Performance Loss" in line or "warning" in line:
                named = re.search(r"function '(\w+)'", line)
                report.setdefault(named.group(1) if named else kernel,
                                  {"source": src.name, "warnings": []}
                                  ).setdefault("warnings", []).append(
                                      line.split(":", 1)[-1].strip())
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("smem_bytes", r"(\d+) bytes smem"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
                m = re.search(pat, line)
                if m:
                    report[kernel][key] = int(m.group(1))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name not in _libs:
            targets = build_all()
            if name not in targets:
                raise KeyError(f"no kernel source csrc/{name}.cu")
            _libs[name] = ctypes.CDLL(str(targets[name]))
        return _libs[name]


def entry(name: str, argtypes):
    """The C launch entry ``<name>_launch`` of ``csrc/<name>.cu``, with
    its argument types declared (pointers and the stream as c_void_p)."""
    lib = library(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return fn


def check(name: str, err: int) -> None:
    """Raise on a non-zero cudaError_t returned by a launch entry."""
    if err != 0:
        msg = library(name).kernel_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}    # ATTN_DISPATCH's
HEAD_DIMS = (16, 32, 64, 128)


def dtype_code(*tensors) -> int:
    """The kernels' dtype code of tensors that must share one dtype."""
    dts = {t.dtype for t in tensors}
    if len(dts) != 1 or next(iter(dts)) not in DTYPE_CODES:
        raise TypeError(f"kernels take one dtype of float32/bfloat16, got "
                        f"{sorted(map(str, dts))}")
    return DTYPE_CODES[dts.pop()]


def check_cuda(*tensors) -> None:
    """Every tensor on one CUDA device; the head dim (last) dense."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"kernel operands must share one CUDA device, "
                         f"got {sorted(map(str, devs))}")
    for t in tensors:
        if t.dim() and t.stride(-1) != 1:
            raise ValueError("kernel operands need a dense last dimension")


def check_rows_aligned(*tensors) -> None:
    """The kernels stage rows with 16-byte loads: every row must start
    16-byte aligned (aligned base, outer strides whole 16-byte units)."""
    for t in tensors:
        unit = 16 // t.element_size()
        if t.data_ptr() % 16 or any(s % unit for s in t.stride()[:-1]):
            raise ValueError(f"kernel operand rows must be 16-byte aligned "
                             f"(strides {t.stride()})")
