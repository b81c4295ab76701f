"""ctypes binding for the C++ checkpoint writer pool (csrc/ckpt_writer.cpp).

Own copy of ``deepspeed_tpu/ops/native/ckpt_writer.py`` (the reference's
py_ds_veloc.cpp binding layer). The library is built with g++ by
``op_builder.CkptWriterBuilder`` at first use; a build or load failure
raises from the constructor."""

import ctypes
import os

from ...op_builder.builder import CkptWriterBuilder
from ...utils import fault_injection


class Writer:
    def __init__(self, threads=4, fsync=False):
        self._lib = CkptWriterBuilder().load()
        self._lib.ckpt_writer_create.restype = ctypes.c_void_p
        self._lib.ckpt_writer_create.argtypes = [ctypes.c_int]
        self._lib.ckpt_writer_destroy.argtypes = [ctypes.c_void_p]
        self._lib.ckpt_writer_write.restype = ctypes.c_int
        self._lib.ckpt_writer_write.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int]
        self._pool = self._lib.ckpt_writer_create(int(threads))
        self._fsync = 1 if fsync else 0

    def write(self, path, data):
        """data: bytes-like (memoryview/bytes/bytearray)."""
        # chaos hook: a 'write' fault here models the C++ pool failing
        # (full disk, dead thread) so the engine's retry/degrade path —
        # not the training step — absorbs it
        fault_injection.fire("write")
        mv = memoryview(data)
        if not mv.c_contiguous:
            mv = memoryview(bytes(mv))
        try:
            # zero-copy when the buffer is writable (BytesIO.getbuffer())
            buf = (ctypes.c_char * mv.nbytes).from_buffer(mv)
        except TypeError:
            buf = (ctypes.c_char * mv.nbytes).from_buffer_copy(mv)
        rc = self._lib.ckpt_writer_write(
            self._pool, str(path).encode(), buf, mv.nbytes, self._fsync)
        if rc != 0:
            raise OSError(-rc, os.strerror(-rc), str(path))

    def close(self):
        if getattr(self, "_pool", None):
            self._lib.ckpt_writer_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
