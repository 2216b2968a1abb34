"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into ONE
shared library with a plain C interface, at first use, and loaded with
:mod:`ctypes` (no PyTorch headers: the build takes seconds, not minutes).
The library lands in ``build/ucod_dpl_tpu_torch/<hash>/`` beside the
package, keyed by a hash of the sources and flags, so an edited kernel
rebuilds and an unchanged one loads at once.  A file lock serialises
processes that build at the same time.  Any build or load failure raises:
there is no fallback to a plain path for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ucod_dpl_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)
LIB_NAME = "libucod_kernels.so"


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA kernels of "
            "ucod_dpl_tpu_torch cannot be built without the CUDA toolkit"
        )
    return found


def build_dir() -> Path:
    """The content-addressed directory the library is (or will be) built in."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the kernels if needed -> (library path, seconds spent building;
    0.0 when an earlier build was reused)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / LIB_NAME
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.is_file():
            return lib, 0.0
        start = time.perf_counter()
        nvcc = _nvcc()
        tmp = out_dir / f"{LIB_NAME}.tmp.{os.getpid()}"
        objs = [out_dir / f"{src.stem}.o" for src in sorted(CSRC.glob("*.cu"))]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / f"{o.stem}.cu"), "-o", str(o)]
                for o in objs]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        results = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
        if all(rc == 0 for _, _, rc in results):
            link = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            results.append((link, proc.stdout, proc.returncode))
        (out_dir / "build.log").write_text(
            "".join(" ".join(c) + "\n" + out for c, out, _ in results))
        failed = [(c, out, rc) for c, out, rc in results if rc != 0]
        if failed:
            tmp.unlink(missing_ok=True)
            c, out, rc = failed[0]
            raise RuntimeError(f"nvcc failed (exit {rc}) building {lib}: {' '.join(c)}\n{out[-6000:]}")
        os.replace(tmp, lib)
        return lib, time.perf_counter() - start


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The built kernel library, with every entry point's C signature declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ucod_attention_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32, ptr]
    lib.ucod_attention_fwd.restype = i32
    lib.ucod_attention_fwd_lse.argtypes = [ptr] * 5 + [i32, i32, i32, i32, f32, i32, ptr]
    lib.ucod_attention_fwd_lse.restype = i32
    lib.ucod_attention_bwd.argtypes = [ptr] * 11 + [i32, i32, i32, i32, f32, i32, ptr]
    lib.ucod_attention_bwd.restype = i32
    lib.ucod_layernorm_qkv.argtypes = [ptr] * 13 + [i32, i32, f32, ptr]
    lib.ucod_layernorm_qkv.restype = i32
    lib.ucod_layernorm_fc1_gelu.argtypes = [ptr] * 7 + [i32, i32, i32, f32, ptr]
    lib.ucod_layernorm_fc1_gelu.restype = i32
    lib.ucod_layernorm_qkv_w8a8.argtypes = [ptr] * 17 + [i32, i32, f32, ptr]
    lib.ucod_layernorm_qkv_w8a8.restype = i32
    lib.ucod_quant_dense_w8a8.argtypes = [ptr] * 7 + [i32, i32, i32, ptr]
    lib.ucod_quant_dense_w8a8.restype = i32
    lib.ucod_layernorm_fc1_gelu_w8a8.argtypes = [ptr] * 10 + [i32, i32, i32, f32, ptr]
    lib.ucod_layernorm_fc1_gelu_w8a8.restype = i32
    lib.ucod_layernorm_mlp_w8a8.argtypes = [ptr] * 12 + [i32, i32, i32, f32, ptr]
    lib.ucod_layernorm_mlp_w8a8.restype = i32
    lib.ucod_attention_outproj.argtypes = [ptr] * 8 + [i32, i32, i32, f32, ptr]
    lib.ucod_attention_outproj.restype = i32
    lib.ucod_patch_embed.argtypes = [ptr] * 5 + [i32, i32, i32, i32, ptr]
    lib.ucod_patch_embed.restype = i32
    return lib


def check_cuda(err: int, what: str) -> None:
    """Raise when a launch returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")
