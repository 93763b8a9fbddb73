"""Build, load and count the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), linked into one shared library with a plain
C interface, and loaded with ctypes.  The library is built at first use
into ``build/repro_torch/<hash>/`` under the repository root, keyed by a
hash of the sources and flags, so a fresh checkout builds once and a
changed source rebuilds.  Nothing here runs at import time.

The flags never include ``--use_fast_math`` or ``-ftz=true``: the sweep's
float32 compares must stay exact on subnormal inputs.

``counters`` holds one launch count per kernel; each wrapper adds to it
where it launches its kernel and nowhere else.  A sweep with uint16
parent slots is also counted under its own ``..._u16p`` name, so a run
can show that the uint16-parent instantiation ran; a symmetric (self-join)
pair sweep is also counted under ``pair_sweep_sym``.  The attention and norm
kernels (#8-#10) and the backward kernels of #8 and #10
(``flash_attention_bwd``, ``rmsnorm_bwd``: one count a call, which is two
launches) are also counted per element type (``flash_attention_bf16`` and
so on).

``on_local_shards`` is how #8 and #10 take DTensors: each is handed its
local shard through ``local_map``, never a ``DTensor``, since the kernels
launch by pointer.

``reported`` is how #8-#10 and the backward kernels tell an active cost
counter (``repro_torch.launch.op_cost.OpCost``) what a call costs: the
wrapper gives the kernel's FLOPs and bytes from its shapes, on every
device, and the plain ops it runs inside (on the CPU) are not counted
again.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "--fmad=false",
)
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C signature of every exported function: name -> (restype, argtypes).
_SIGNATURES = {
    "repro_error_string": (ctypes.c_char_p, [_I]),
    "repro_level_sweep": (_I, [_P, _P, _P, _P, _I, _I, _LL, _I, _LL, _I, _I,
                               _I, _P]),
    "repro_level_sweep_hier_scratch": (_LL, [_LL, _LL, _I, _I]),
    "repro_level_sweep_hier": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I,
                                    _LL, _I, _I, _I, _P]),
    "repro_level_sweep_stream_workspace": (_LL, [_LL]),
    "repro_level_sweep_stream": (_I, [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _LL, _I,
                                      _LL, _I, _I, _I, _P]),
    "repro_mbr_scan": (_I, [_P, _LL, _LL, _P, _P, _LL, _LL, _I, _P]),
    "repro_build_levels_workspace": (_LL, [_LL]),
    "repro_build_levels": (_I, [_P, _P, _P, _P, _P, _P, _LL, _I, _P]),
    "repro_quantize_cm": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _P]),
    "repro_pair_sweep": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _P]),
    "repro_rmsnorm": (_I, [_P, _P, _P, _LL, _I, _I, _I, _F, _P]),
    "repro_mqr_sparse_attention_workspace": (_LL, [_LL, _I, _I, _I, _I, _I, _I]),
    "repro_mqr_sparse_attention": (_I, [_P, _P, _P, _P, _P, _LL, _P, _P, _LL, _I, _I, _I, _I,
                                        _I, _I, _F, _P]),
    "repro_flash_attention": (_I, [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _F, _P]),
    "repro_flash_attention_bwd": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _F,
                                       _P]),
    "repro_flash_attention_bwd_workspace": (_LL, [_LL, _I]),
    "repro_rmsnorm_bwd_blocks": (_LL, [_LL]),
    "repro_rmsnorm_bwd": (_I, [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _F, _P]),
}

# Element types that cross the C interface as a code (``ReproDtype`` in
# ``csrc/common.cuh``).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


class LaunchCounters:
    """Launch count per kernel name."""

    def __init__(self):
        self._counts: dict[str, int] = {}

    def add(self, name: str, n: int = 1) -> None:
        self._counts[name] = self._counts.get(name, 0) + n

    def reset(self) -> None:
        self._counts.clear()

    def snapshot(self) -> dict[str, int]:
        return dict(self._counts)


counters = LaunchCounters()

# the active cost counters (``OpCost`` adds itself while it counts)
cost_sinks: list = []


@contextlib.contextmanager
def reported(name: str, flops: int, nbytes: int):
    """One wrapper call of kernel ``name``: ``flops`` and ``nbytes`` go to
    every active cost counter, which counts no operator run inside the
    block.  Nothing happens when no counter is active."""
    sinks = tuple(cost_sinks)
    for sink in sinks:
        sink.kernel_enter(name, flops, nbytes)
    try:
        yield
    finally:
        for sink in sinks:
            sink.kernel_exit()


def on_local_shards(fn, args, in_placements, out_placements, in_grad_placements,
                    n_out: int = 1):
    """``fn`` on the local shards of the DTensors ``args``, through
    ``torch.distributed.tensor.experimental.local_map``.  Each argument is
    first redistributed to its entry of ``in_placements`` where its
    placements differ (a collective, which an active ``OpCost`` counts):
    a kernel is never handed a placement it cannot take.  The outputs are
    wrapped with ``out_placements`` (``fn`` returns one tensor, or a tuple
    of ``n_out`` tensors placed alike); ``in_grad_placements`` says how the
    gradient of each local shard lies (``Partial`` where the shards'
    gradients add up)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = args[0].device_mesh
    args = [a if tuple(a.placements) == tuple(p) else a.redistribute(mesh, tuple(p))
            for a, p in zip(args, in_placements)]
    return local_map(fn, out_placements=(tuple(out_placements),) * n_out,
                     in_placements=tuple(tuple(p) for p in in_placements),
                     in_grad_placements=tuple(tuple(p) for p in in_grad_placements),
                     device_mesh=mesh)(*args)


def nbytes(*tensors: torch.Tensor) -> int:
    """Bytes of the tensors' elements."""
    return sum(t.numel() * t.element_size() for t in tensors)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are built from "
        f"{CSRC} at first use and need the CUDA toolkit"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """Directory of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link the shared library;
    returns its path.  A no-op when the library for these sources exists."""
    out = build_dir()
    lib_path = out / LIB_NAME
    if lib_path.exists():
        return lib_path
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=out))
    try:
        procs = []
        for src in _sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            log, _ = p.communicate()
            logs.append(f"== {src.name}\n{log}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp_lib = work / LIB_NAME
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = load().repro_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")


def require(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Validate a kernel argument before its pointer crosses into C."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dtype_code(t: torch.Tensor, name: str) -> int:
    """The C dtype code of a float32 or bfloat16 argument."""
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def require_aligned(t: torch.Tensor, name: str, nbytes: int = 16) -> None:
    """A kernel that loads ``nbytes`` at a time needs its base aligned."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name} must be {nbytes}-byte aligned")


def require_block(width: int, name: str) -> None:
    """A thread-block width must be a multiple of 32 in [32, 1024]."""
    if width % 32 or not 32 <= width <= 1024:
        raise ValueError(f"{name} must be a multiple of 32 in [32, 1024], got {width}")


def require_device(tensors: dict, device: torch.device) -> None:
    """All arguments of one launch must live on the same device."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
