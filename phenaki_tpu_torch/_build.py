"""Build and load the port's CUDA kernels.

`load_library()` compiles every `csrc/*.cu` into one shared library with a
plain C interface at first CUDA use, and loads it with ctypes. The sources
compile in parallel, one nvcc process each, into objects that one more nvcc
call links. The build is keyed by a hash of the sources (and the nvcc
command), so it reruns only when a source changes. Nothing here runs at
import time: the CPU tests import every module on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",  # each kernel's registers, spills and shared memory, into the build log
]

# dtype codes of the C entry points
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None
_so: Optional[Path] = None  # the loaded library; nvcc's output is beside it (.log)
# wall seconds of the last nvcc run in this process (0.0 when the cached
# library was reused)
build_seconds: float = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_ulonglong
_L = ctypes.c_longlong

# C entry points: name -> argtypes. Every entry point returns the
# cudaError_t of its launches (0 = success).
_SIGNATURES = {
    "flash_attention_fwd": [
        _P, _P, _P,  # q, k, v
        _P, _P,  # bias (h, i, ldb) read at columns [0, j), or null; kmask (b, j) f32 or null
        _P, _P,  # out, lse (b, h, i) f32 or null
        _I, _I, _I, _I, _I, _I,  # b, h, i, j, d, ldb (the bias row stride)
        _F, _I, _I,  # scale, causal, dtype (0 = f32, 1 = bf16)
        _P,  # stream
    ],
    "flash_attend_chunk_fwd": [
        _P, _P, _P,  # q, k, v
        _P, _P,  # bias (h, i, ldb) read at columns [0, j), or null; kmask (b, j) f32 or null
        _P,  # c2: one f32 on the device (the ring's shared bound, log2 units)
        _P, _P,  # acc (b, h, i, d) f32, l (b, h, i) f32
        _I, _I, _I, _I, _I, _I,  # b, h, i, j, d, ldb
        _F, _I, _I, _I, _I,  # scale, causal, q_off, k_off, dtype (0 = f32, 1 = bf16)
        _P,  # stream
    ],
    **{
        f"flash_attention_bwd_{which}": [
            _P, _P, _P,  # q, k, v
            _P, _P,  # bias (h, i, ldb) read at columns [0, j), or null; kmask (b, j) f32 or null
            _P, _P, _P,  # dout, lse (b, h, i) f32, delta (b, h, i) f32
            *outputs,
            _I, _I, _I, _I, _I, _I,  # b, h, i, j, d, ldb
            _F, _I, _I, _I, _I,  # scale, causal, q_off, k_off, dtype (0 = f32, 1 = bf16)
            _P,  # stream
        ]
        for which, outputs in (("dq", [_P]),  # dq
                               ("dkv", [_P, _P]),  # dk, dv
                               ("dbias", [_P]))  # dbias (h, i, j) f32
    },
    "fused_ce_fwd": [
        _P, _P, _P, _P,  # h (R, d), w (V, d), bias (V,) f32 or null, labels (R,) int32
        _P, _P,  # loss, lse (R,) f32
        _P, _P,  # label_logit (R,), partials (R, splits, 2) f32 scratch
        _I, _I, _I, _I, _I,  # R, d, V, splits, dtype (0 = f32, 1 = bf16)
        _P,  # stream
    ],
    "fused_ce_bwd_dh": [
        _P, _P, _P, _P,  # h, w, bias or null, labels
        _P, _P,  # lse, g (R,) f32
        _P, _P,  # dh (R, d) f32, partials (splits, rows_pad, d) f32 scratch
        _I, _I, _I, _I, _I, _I,  # R, d, V, splits, rows_pad (round_up(R, 64)), dtype
        _P,  # stream
    ],
    "fused_ce_bwd_dw": [
        _P, _P, _P, _P,  # h, w, bias or null, labels
        _P, _P,  # lse, g (R,) f32
        _P, _P,  # dw (V, d) f32, db (V,) f32
        _I, _I, _I, _I,  # R, d, V, dtype
        _P,  # stream
    ],
    "proj_sample": [
        _P, _P, _P,  # h (rows, d), w (V, d), bias (V,) f32 or null
        _P,  # noise (rows, V) f32 or null
        _P, _P,  # ids (rows,) int32, score (rows,) f32
        _P,  # partials scratch (rows, splits, 5) f32
        _I, _I, _I, _I,  # rows, d, V, splits (bf16: 1..V / 128; f32: V / 64)
        _F, _U64, _I,  # temperature, seed, dtype (0 = f32, 1 = bf16)
        _P,  # stream
    ],
    "gumbel_sample": [
        _P, _P,  # logits (rows, V), or (2 * rows, V) stacked cond/null; noise (rows, V) f32 or null
        _P, _P,  # ids (rows,) int32, score (rows,) f32
        _I, _I,  # rows, V
        _F, _I, _F,  # 1 / max(temperature, 1e-10), has_cfg, cond_scale
        _U64, _I,  # seed, dtype (0 = f32, 1 = bf16)
        _P,  # stream
    ],
    "peg_stencil": [
        _P, _P, _P, _P,  # x (b, t, h, w, d), weight (d, 1, 3, 3, 3), bias (d,), out like x
        _I, _I, _I, _I, _I,  # b, t, h, w, d
        _L, _L, _L, _L, _L, _L, _L, _L,  # x's and out's strides of (b, t, h, w), in elements
        _I, _I, _I,  # causal, dtype, the weight's and bias's dtype (0 = f32, 1 = bf16)
        _P,  # stream
    ],
    "layer_norm_fwd": [
        _P, _P, _P, _P,  # x (rows, d), gamma (d,), beta (d,) or null, out (rows, d)
        _L, _I, _L, _L,  # rows, d, x's and out's row strides in elements
        _F, _I, _I,  # eps, dtype, gamma's and beta's dtype (0 = f32, 1 = bf16, 2 = f16)
        _P,  # stream
    ],
    "geglu_gemm": [
        _P, _P,  # x (rows, d), proj_in's packed weight (2 * ip, d)
        _P, _P,  # h (rows, ip), the packed pre-activation (rows, 2 * ip) or null
        _I, _I, _I, _I, _I,  # rows, d, ip, splits (bf16: 1..2 * ip / 128), dtype (0 = f32, 1 = bf16)
        _P,  # stream
    ],
    "qk_norm_split": [
        _P, _P, _P,  # q (b, n, h * d), k and v (b, m, h * d)
        _P, _P,  # null k and null v (h, num_null, d), or null
        _P, _P,  # q_scale, k_scale (d,)
        _P, _P, _P,  # q_out (b, h, n, d), k_out and v_out (b, h, num_null + m, d)
        _I, _I, _I, _I, _I, _I,  # b, n, m, num_null, h, d
        _L, _L, _L, _L, _L, _L, _L, _L,  # strides of q, k, v (b, token) and of the nulls (head, row)
        _I, _I,  # dtype, the scales' dtype (0 = f32, 1 = bf16, 2 = f16)
        _P,  # stream
    ],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of phenaki_tpu_torch cannot be built"
    )


def _source_key(cmd) -> str:
    h = hashlib.sha256(" ".join(cmd).encode())
    for p in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernels' shared library. Processes
    that start together (the ranks of a process group) build it once: the
    build runs under an exclusive file lock, and a process that waited for
    the lock finds the library built."""
    global _lib, _so
    if _lib is not None:
        return _lib
    nvcc = _nvcc()
    sources = [str(p) for p in sorted(_CSRC.glob("*.cu"))]
    base = [nvcc, *NVCC_FLAGS, f"-I{_CSRC}"]
    so = _BUILD_DIR / f"libphenaki_kernels_{_source_key(base)}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(so.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not so.exists():
                    _compile(base, sources, so)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.phenaki_error_string.argtypes = [ctypes.c_int]
    lib.phenaki_error_string.restype = ctypes.c_char_p
    _lib, _so = lib, so
    return lib


def _compile(base, sources, so: Path) -> None:
    """One nvcc per source in parallel, then the link, into `so`."""
    global build_seconds
    tag = f"{so.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    objects = [str(_BUILD_DIR / f"{tag}.{Path(src).stem}.o") for src in sources]
    procs = [
        subprocess.Popen([*base, "-c", "-o", obj, src], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objects)
    ]
    outputs = [p.communicate()[0] for p in procs]
    for src, p, out in zip(sources, procs, outputs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} ({p.returncode}):\n{out}")
    so.with_suffix(".log").write_text("".join(f"== {src}\n{out}" for src, out in zip(sources, outputs)))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([*base, "-shared", "-o", str(tmp), *objects],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    for obj in objects:
        os.remove(obj)
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0


def library_path() -> Path:
    """The loaded library's file (after `load_library()`)."""
    return _so


def ptxas_report(kernel: str) -> list:
    """The build log's ptxas lines (registers, spills, shared memory) of the
    kernels whose mangled names contain `kernel`, one string a kernel."""
    log = _so.with_suffix(".log") if _so is not None else None
    lines = log.read_text().splitlines() if log is not None and log.exists() else []
    report, current = [], None
    for line in lines:
        if "Compiling entry function" in line:
            current = [line.split("'")[1]] if kernel in line else None
            if current is not None:
                report.append(current)
        elif current is not None and line.strip() and "Function properties" not in line:
            current.append(line.replace("ptxas info    :", "").strip())
    return [" | ".join(r) for r in report]


def on_card(what: str, x: torch.Tensor, *others) -> bool:
    """Which route a kernel's wrapper takes: False for a CPU tensor (the
    plain version), True for CUDA tensors on one device; raises for any
    other device, or operands (None aside) on two. `what` names the kernel
    in the error."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {x.device}")
    if any(t is not None and t.device != x.device for t in others):
        raise ValueError(f"{what}: all operands must be on one device")
    return True


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """A tensor's device pointer (null for None) as a ctypes argument."""
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, as a ctypes argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = _lib.phenaki_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
