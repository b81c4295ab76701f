"""Op builder: compile the port's CUDA sources with nvcc and its host C++
sources with g++, load with ctypes.

Counterpart of ``deepspeed_tpu/op_builder/builder.py`` (``OpBuilder.load``:
hash the sources and flags, build once into a content-addressed file,
atomic tmp -> rename). Each ``csrc/*.cu`` exposes a plain ``extern "C"``
interface, so the library is built with nvcc alone (no PyTorch headers,
seconds instead of minutes) and bound with ctypes; ``HostOpBuilder``
builds a host-only ``csrc/*.cpp`` (the checkpoint writer pool) with g++
the same way.

Output: ``<repo>/build/deepspeed_tpu_torch/<name>-<hash>.so``. The build
happens at first use. A missing compiler or a failed build raises — there
is no stub library and no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from ..utils.logging import logger

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "deepspeed_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]


def find_nvcc():
    """Path of nvcc: on PATH, else the toolkit's default location, else
    None."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


class CUDAOpBuilder:
    NAME = None
    SOURCES = ()
    DEPENDS = ()      # headers the sources include (hashed, not compiled)
    COMPILER = "nvcc"

    def flags(self):
        return NVCC_FLAGS

    def find_compiler(self):
        return find_nvcc()

    def __init__(self):
        self._lib = None
        self.build_log = ""        # nvcc's stderr (ptxas register report)
        self.build_seconds = 0.0   # 0 when the library was already built

    def absolute_sources(self):
        return [os.path.join(CSRC, s) for s in self.SOURCES]

    def build_hash(self):
        h = hashlib.sha256()
        for s in self.absolute_sources() + [os.path.join(CSRC, d)
                                            for d in self.DEPENDS]:
            with open(s, "rb") as f:
                h.update(f.read())
        h.update(" ".join(self.flags()).encode())
        return h.hexdigest()[:16]

    def so_path(self):
        return os.path.join(BUILD_DIR, f"{self.NAME}-{self.build_hash()}.so")

    def start_build(self):
        """Start nvcc on this op's sources unless the content-addressed
        library exists; returns the running process, or None when there is
        nothing to build."""
        so = self.so_path()
        if os.path.exists(so):
            return None
        compiler = self.find_compiler()
        if compiler is None:
            raise RuntimeError(
                f"cannot build op '{self.NAME}': {self.COMPILER} not found")
        os.makedirs(BUILD_DIR, exist_ok=True)
        self._tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [compiler] + self.flags() + self.absolute_sources() + [
            "-o", self._tmp]
        logger.info(f"building op '{self.NAME}': {' '.join(cmd)}")
        self._t0 = time.perf_counter()
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def finish_build(self, proc):
        """Wait for ``proc`` (from start_build) and install the library;
        returns its path."""
        so = self.so_path()
        if proc is None:
            return so
        out, err = proc.communicate()
        self.build_seconds = time.perf_counter() - self._t0
        self.build_log = err
        if proc.returncode != 0:
            raise RuntimeError(
                f"{self.COMPILER} failed for op '{self.NAME}' "
                f"(rc={proc.returncode}):\n{out}\n{err}")
        os.replace(self._tmp, so)
        return so

    def build(self):
        """Compile (if the content-addressed library is missing); returns
        its path."""
        return self.finish_build(self.start_build())

    def load(self):
        """Build if needed and return the loaded ctypes CDLL."""
        if self._lib is None:
            self._lib = ctypes.CDLL(self.build())
        return self._lib


class PagedAttentionBuilder(CUDAOpBuilder):
    NAME = "paged_attention"
    SOURCES = ("paged_attention.cu",)
    DEPENDS = ("attention_tiles.cuh", "sm90_gemm.cuh", "sm90_attention.cuh")


class FlashAttentionBuilder(CUDAOpBuilder):
    NAME = "flash_attention"
    SOURCES = ("flash_attention.cu",)
    DEPENDS = ("attention_tiles.cuh", "sm90_gemm.cuh", "sm90_attention.cuh")


class BlockSparseAttentionBuilder(CUDAOpBuilder):
    NAME = "block_sparse_attention"
    SOURCES = ("block_sparse_attention.cu",)
    DEPENDS = ("attention_tiles.cuh", "sm90_gemm.cuh", "sm90_attention.cuh")


class FusedCEBuilder(CUDAOpBuilder):
    NAME = "fused_ce"
    SOURCES = ("fused_ce.cu",)
    DEPENDS = ("sm90_gemm.cuh",)


class GroupedMatmulBuilder(CUDAOpBuilder):
    NAME = "grouped_matmul"
    SOURCES = ("grouped_matmul.cu",)
    DEPENDS = ("gemm_common.cuh", "wq_gemm.cuh", "sm90_gemm.cuh",
               "sm90_attention.cuh", "wq_sm90.cuh")


class MlpMatmulBuilder(CUDAOpBuilder):
    NAME = "mlp_matmul"
    SOURCES = ("mlp_matmul.cu",)
    DEPENDS = ("gemm_common.cuh", "wq_gemm.cuh", "sm90_gemm.cuh",
               "sm90_attention.cuh", "wq_sm90.cuh")


class LayerNormBuilder(CUDAOpBuilder):
    NAME = "layernorm"
    SOURCES = ("layernorm.cu",)


class QuantizationBuilder(CUDAOpBuilder):
    NAME = "quantization"
    SOURCES = ("quantization.cu",)


class HostOpBuilder(CUDAOpBuilder):
    """A host-only C++ library (``csrc/*.cpp``, a C interface), built with
    g++ into the same content-addressed place (the JAX
    ``op_builder/builder.py:85-100`` ``OpBuilder.load``)."""
    COMPILER = "g++"

    def flags(self):
        return GXX_FLAGS

    def find_compiler(self):
        return shutil.which("g++")


class CkptWriterBuilder(HostOpBuilder):
    NAME = "ckpt_writer"
    SOURCES = ("ckpt_writer.cpp",)
    DEPENDS = ("pool.h",)


def build_all(builders):
    """Build the library of each of ``builders`` with one compiler per
    source, all started together, and wait for all of them; a failed build
    raises after every process has ended."""
    procs = []
    try:
        for b in builders:
            procs.append((b, b.start_build()))
    finally:
        errors = []
        for b, p in procs:
            try:
                b.finish_build(p)
            except RuntimeError as e:
                errors.append(e)
    if errors:
        raise errors[0]
