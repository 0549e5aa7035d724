"""Build and load the port's CUDA kernels (one shared library).

Every ``csrc/*.cu`` under ``repro_torch/kernels`` is compiled by ``nvcc``
for Hopper (``sm_90a``) with FMA contraction off (``-fmad=false``: the
float64 cost plane must equal NumPy's to the last bit), each source in
its own ``nvcc`` process, all started together, then linked into one
``.so`` with a plain C interface that ``ctypes`` loads. The library is
built at first use from the checkout's sources only, into
``<repo>/build/repro_torch/<hash>/``, keyed by a hash of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused.

Nothing here runs at import: the CPU tests import every module on a
machine with no ``nvcc``.
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

__all__ = [
    "SOURCES", "NVCC_FLAGS", "build", "library", "check", "launch_device", "strided_device",
    "check_rows", "stream_of",
]

_KERNELS = Path(__file__).resolve().parent
SOURCES = tuple(sorted(_KERNELS.glob("*/csrc/*.cu")))
BUILD_ROOT = _KERNELS.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "librepro_torch.so"

_c = ctypes
_P = _c.c_void_p
_I64 = _c.c_int64
# C signatures of the library's entry points (every pointer and the
# stream as c_void_p, so ctypes never truncates them to 32 bits).
_SIGNATURES = {
    # jb, jw, wc, wd, rows, out; J, S; weights; scratch; stream
    "repro_cost_matrix_f32": (_P, _P, _P, _P, _P, _P, _I64, _I64,
                              _c.c_float, _c.c_float, _c.c_float, _P, _P),
    # bytes, work, cls, rows, alive, out; J, S; weights; mask_dead; scratch; stream
    "repro_cost_matrix_f64": (_P, _P, _P, _P, _P, _P, _I64, _I64,
                              _c.c_double, _c.c_double, _c.c_double, _c.c_int, _P, _P),
    # bytes, work, cls, rows, alive, best, best_cost; J, S; weights; scratch; stream
    "repro_cost_argmin_f64": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                              _c.c_double, _c.c_double, _c.c_double, _P, _P),
    "repro_priority_requeue_f32": (_P, _P, _P, _c.c_float, _c.c_float,
                                   _P, _P, _I64, _P),
    "repro_priority_requeue_f64": (_P, _P, _P, _c.c_double, _c.c_double,
                                   _P, _P, _I64, _P),
    # q, k, v, o; B, H, KV, Sq, Sk, D (q and k), Dv (v and o); q strides;
    # k/v strides; causal, window, softcap; stream
    **{f"repro_flash_attention_{t}": (_P, _P, _P, _P, *(_I64,) * 7, *(_I64,) * 6,
                                      _c.c_int, _I64, _c.c_float, _P)
       for t in ("f32", "bf16")},
    # q, k, v, o, dO, dq, dk, dv, lse, delta; B, H, KV, Sq, Sk, D, Dv; q strides;
    # k/v strides; causal, window, softcap; stream
    **{f"repro_flash_attention_bwd_{t}": (*(_P,) * 10, *(_I64,) * 7, *(_I64,) * 6,
                                          _c.c_int, _I64, _c.c_float, _P)
       for t in ("f32", "bf16")},
    # q, k, v, o, ws_m, ws_l, ws_acc; B, KV, rep, S, D, pos; k/v strides;
    # window, softcap, split; stream
    **{f"repro_decode_attention_{t}": (*(_P,) * 7, *(_I64,) * 6, *(_I64,) * 3,
                                       _I64, _c.c_float, _I64, _P)
       for t in ("f32", "bf16")},
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless this exact source set is built; return
    its path. Raises with nvcc's output when a compile or link fails."""
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        log = []
        failed = []
        for src, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name} (exit {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        (out_dir / "nvcc.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def _one_device(name: str, args: dict) -> torch.device:
    """The common device of a wrapper's tensors: every argument a tensor,
    all on one device, and that device the host or a CUDA card."""
    for key, t in args.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {key} must be a torch.Tensor, got {type(t).__name__}")
    devices = {t.device for t in args.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel or plain version for device {dev}")
    return dev


def launch_device(name: str, args: dict, dtypes: dict, shapes: dict):
    """Validate a wrapper's tensors and return their common device.

    ``args`` maps argument names to tensors, ``dtypes``/``shapes`` give
    what each must be (a shape entry of None skips that dimension). All
    tensors must share one device and be contiguous: the kernels take
    raw pointers with the layout they assume.
    """
    dev = _one_device(name, args)
    for key, t in args.items():
        if t.dtype != dtypes[key]:
            raise TypeError(f"{name}: {key} must be {dtypes[key]}, got {t.dtype}")
        want = shapes[key]
        if t.dim() != len(want) or any(w is not None and w != d for w, d in zip(want, t.shape)):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return dev


def strided_device(name: str, args: dict, dtypes: tuple) -> tuple[torch.device, torch.dtype]:
    """Validate the tensors of a wrapper whose kernel reads through
    strides; return their common device and type, one of ``dtypes``."""
    dev = _one_device(name, args)
    types = {t.dtype for t in args.values()}
    if len(types) != 1 or next(iter(types)) not in dtypes:
        raise TypeError(f"{name}: tensors must share one type of {list(dtypes)}, got {sorted(map(str, types))}")
    return dev, types.pop()


def check_rows(name: str, args: dict) -> None:
    """A strided kernel's tensors: the last dimension contiguous, and the
    base and every other stride on 16 bytes (its vector loads)."""
    for key, t in args.items():
        per16 = 16 // t.element_size()
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {key} must have a contiguous last dimension")
        if t.data_ptr() % 16 or any(s % per16 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: {key} must start and stride on 16 bytes, strides {t.stride()}")


def stream_of(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
