"""The native (C++) host path of the input pipeline, bound with ctypes.

``tfrecord_native.cc`` (this package's own source) is compiled at first use
with ``g++ -O3 -shared -fPIC -std=c++17 -DLDM_NATIVE_JPEG ... -ljpeg`` into
``build/ldm_tf2_tpu_torch/`` at the repository root (``ops/_build.py``'s
``BUILD_DIR``, never beside the source), as ``libldm_native-<hash>.so``,
the hash covering the source, the compiler and its flags, so an edited
source is rebuilt and an unchanged one reused.  Where libjpeg's headers or
library are missing, the source is built again without its JPEG part:
the framing, CRC and Example walk then run natively and the decode in
Python (``has_decode()`` is False).  Nothing is built at import time.

  crc32c(bytes) -> int
  NativeRecordFile(path, verify_crc)  the records of a mapped file
  example_image_bytes(record) -> bytes    the "image" feature's bytes
  example_caption(record, max_len) -> np.int64 [max_len]
  scan_index(path) -> np.int64 [N, 2]     (payload offset, length)
  pread(path, offset, length) -> bytes
  decode_and_process(jpeg, image_size, flip) -> float32 [S, S, 3]

``available()`` says whether the loaders use it: where the library does not
build, it is False, the loaders take the Python path, and the compiler's
message is printed once to stderr.  ``require()`` (a loader's
``native=True``, which needs the framing, CRC and Example walk) raises
instead.  ``set_enabled(False)`` sends the loaders to the Python path.
``fallbacks`` counts the records whose image libjpeg rejected, which the
Python path then decoded (``decode_or_none``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
JPEG_FLAGS = ("-DLDM_NATIVE_JPEG", "-ljpeg")
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tfrecord_native.cc")

_lock = threading.Lock()
_lib = None
_tried = False
_error = ""  # the compiler's message when no library built
_enabled = True
fallbacks = 0  # records whose image the Python path decoded


def library_path(jpeg: bool = True) -> str:
    """Where the library builds (``jpeg``: with the JPEG part)."""
    from ldm_tf2_tpu_torch.ops._build import BUILD_DIR

    digest = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS + (JPEG_FLAGS if jpeg else ()))
                            .encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    tag = "" if jpeg else "-nojpeg"
    return os.path.join(BUILD_DIR, f"libldm_native{tag}-{digest.hexdigest()[:16]}.so")


def _compile(out: str, jpeg: bool) -> str:
    """Build ``out`` (into a temporary name, then renamed, so that processes
    building at once never load a partial file); the compiler's message
    where it failed, else ""."""
    flags = JPEG_FLAGS if jpeg else ()
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [CXX, *CXX_FLAGS, *flags[:1], SOURCE, "-o", tmp, *flags[1:]]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{' '.join(cmd)}: {e}"
    if done.returncode != 0:
        return f"{' '.join(cmd)} exited {done.returncode}:\n{done.stdout}{done.stderr}"
    os.replace(tmp, out)
    return ""


def _bind(lib):
    u8p, i64p, size = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64), \
        ctypes.c_size_t
    sigs = {
        "ldm_native_has_jpeg": (ctypes.c_int, []),
        "ldm_crc32c": (ctypes.c_uint32, [ctypes.c_char_p, size]),
        "ldm_tfrecord_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int]),
        "ldm_tfrecord_num_records": (ctypes.c_long, [ctypes.c_void_p]),
        "ldm_tfrecord_record": (u8p, [ctypes.c_void_p, ctypes.c_long,
                                      ctypes.POINTER(size)]),
        "ldm_tfrecord_close": (None, [ctypes.c_void_p]),
        "ldm_example_bytes": (ctypes.c_long, [ctypes.c_char_p, size, ctypes.c_char_p,
                                              ctypes.POINTER(u8p), ctypes.POINTER(size)]),
        "ldm_example_int64s": (ctypes.c_long, [ctypes.c_char_p, size, ctypes.c_char_p,
                                               i64p, ctypes.c_long]),
        "ldm_tfrecord_scan": (ctypes.c_long, [ctypes.c_char_p, ctypes.POINTER(i64p)]),
        "ldm_free": (None, [ctypes.c_void_p]),
        "ldm_pread": (ctypes.c_long, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, u8p]),
    }
    if lib.ldm_native_has_jpeg():
        sigs["ldm_decode_and_process"] = (ctypes.c_int, [
            ctypes.c_char_p, size, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)])
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _load():
    """The library, built on first use (None where it does not build)."""
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        errors = []
        for jpeg in (True, False):
            path = library_path(jpeg)
            if not os.path.exists(path):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                error = _compile(path, jpeg)
                if error:
                    errors.append(error)
                    continue
            try:
                _lib = _bind(ctypes.CDLL(path))
            except OSError as e:
                errors.append(f"loading {path}: {e}")
                continue
            break
        _error, _tried = "\n".join(errors), True
        if _lib is None:
            print(f"[native] the C++ reader did not build; the loaders take the Python "
                  f"path:\n{_error}", file=sys.stderr, flush=True)
        elif errors:
            print(f"[native] the C++ reader built without its JPEG decode (libjpeg "
                  f"missing); images decode in Python:\n{_error}", file=sys.stderr,
                  flush=True)
        return _lib


def set_enabled(flag: bool) -> None:
    """False sends the loaders to the Python path (A/B runs and tests)."""
    global _enabled
    _enabled = bool(flag)


def available() -> bool:
    """Whether the loaders use the native reader: enabled, and built."""
    return _enabled and _load() is not None


def has_decode() -> bool:
    """Whether the built library holds the JPEG decode (libjpeg)."""
    lib = _load()
    return lib is not None and bool(lib.ldm_native_has_jpeg())


def require(decode: bool = True) -> None:
    """Raise where the native reader (with its decode, ``decode``) is not
    available, with the compiler's message."""
    if not _enabled:
        raise RuntimeError("the native reader is disabled (native.set_enabled(False))")
    if _load() is None:
        raise RuntimeError(f"the native reader did not build:\n{_error}")
    if decode and not has_decode():
        raise RuntimeError(f"the native reader built without its JPEG decode:\n{_error}")


def use(native: bool | None) -> bool:
    """A loader's choice: ``native`` None takes the reader where it is
    available; True requires it (its framing, CRC and Example walk;
    ``require(decode=False)``); False never takes it.  A loader that takes
    it decodes natively where ``has_decode()``."""
    if native:
        require(decode=False)
        return True
    return native is None and available()


def crc32c(data: bytes) -> int:
    return int(_load().ldm_crc32c(data, len(data)))


class NativeRecordFile:
    """A TFRecord file mapped read-only; its records as bytes."""

    def __init__(self, path: str, verify_crc: bool = False):
        self._lib = _load()
        self._h = self._lib.ldm_tfrecord_open(path.encode(), int(verify_crc))
        if not self._h:
            raise IOError(f"cannot read the records of {path}")

    def __len__(self) -> int:
        return int(self._lib.ldm_tfrecord_num_records(self._h))

    def record(self, i: int) -> bytes:
        n = ctypes.c_size_t()
        ptr = self._lib.ldm_tfrecord_record(self._h, i, ctypes.byref(n))
        if not ptr:
            raise IndexError(i)
        return ctypes.string_at(ptr, n.value)

    def __iter__(self):
        for i in range(len(self)):
            yield self.record(i)

    def close(self) -> None:
        if self._h:
            self._lib.ldm_tfrecord_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def example_image_bytes(record: bytes, name: bytes = b"image") -> bytes | None:
    """The first bytes of feature ``name`` (None where it has none)."""
    ptr, n = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_size_t()
    if _load().ldm_example_bytes(record, len(record), name, ctypes.byref(ptr),
                                 ctypes.byref(n)) < 0:
        return None
    return ctypes.string_at(ptr, n.value)


def example_caption(record: bytes, max_len: int = 77) -> np.ndarray | None:
    """The "caption" int64 list, truncated or zero-padded to ``max_len``
    (None where the record has none)."""
    out = np.zeros(max_len, dtype=np.int64)
    if _load().ldm_example_int64s(record, len(record), b"caption",
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                  max_len) < 0:
        return None
    return out


def scan_index(path: str) -> np.ndarray | None:
    """[N, 2] int64 (payload offset, payload length) from the framing
    alone (None where the file cannot be read)."""
    lib = _load()
    ptr = ctypes.POINTER(ctypes.c_int64)()
    n = lib.ldm_tfrecord_scan(path.encode(), ctypes.byref(ptr))
    if n < 0:
        return None
    if n == 0:
        return np.zeros((0, 2), dtype=np.int64)
    try:
        return np.ctypeslib.as_array(ptr, shape=(n, 2)).copy()
    finally:
        lib.ldm_free(ptr)


def pread(path: str, offset: int, length: int) -> bytes | None:
    """``length`` bytes of ``path`` at ``offset`` (None on a short read)."""
    out = (ctypes.c_uint8 * length)()
    if _load().ldm_pread(path.encode(), offset, length, out) != length:
        return None
    return bytes(out)


def decode_and_process(jpeg: bytes, image_size: int, flip: bool = False
                       ) -> np.ndarray | None:
    """libjpeg's RGB decode through ``dataset.process_image``'s chain, then
    the flip: [image_size, image_size, 3] float32 (None where libjpeg
    rejects the data)."""
    out = np.empty((image_size, image_size, 3), dtype=np.float32)
    if _load().ldm_decode_and_process(jpeg, len(jpeg), image_size, int(flip),
                                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))):
        return None
    return out


def decode_or_none(record: bytes, image_size: int, flip: bool, with_captions: bool,
                   max_seq_len: int):
    """One record through the native walk and decode (the library must
    have its decode), as ``dataset._make_example`` returns it; None
    (counted in ``fallbacks``) where the record has no image or caption for
    it or libjpeg rejects the image: the caller decodes it in Python."""
    global fallbacks
    jpeg = example_image_bytes(record)
    image = None if jpeg is None else decode_and_process(jpeg, image_size, flip)
    caption = example_caption(record, max_seq_len) if with_captions else None
    if image is None or (with_captions and caption is None):
        with _lock:
            fallbacks += 1
        return None
    return (image, caption) if with_captions else image
