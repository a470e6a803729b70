"""Native (C++) helpers of the data pipeline, with ctypes bindings: the
port's own copy of fourm_tpu/native/ (tar_reader.cpp), a PNG row
reconstruction (png_unfilter.cpp) and a JPEG decoder (jpeg_decode.cpp) for
data/image_io.py, and a zstd decoder with CRC-32C (zstd_decode.cpp) for the
orbax checkpoints that utils/orbax.py reads and writes.

`tar_reader`: indexed tar-shard reading (one pread per member, no
per-member Python object churn). The sources are one library, built
with g++ -O3 at first use into `_build/` beside them (ignored by git),
named after the hash of the sources, so an edited source rebuilds. The
build writes a temporary file and renames it, so that worker processes
building at once do not read a half-written library. Without a compiler
the tar and PNG callers fall back to Python (tarfile; numpy row
reconstruction), and `native_available()` says which; `decode_jpeg`,
`decode_zstd` and `crc32c` have no fallback and raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCES = ("tar_reader.cpp", "png_unfilter.cpp", "jpeg_decode.cpp", "zstd_decode.cpp")
BUILD_DIR = _DIR / "_build"
_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
_lib = None
_build_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in SOURCES:
        h.update((_DIR / s).read_bytes())
    return BUILD_DIR / f"libfourm_native_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".build_", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, *(str(_DIR / s) for s in SOURCES), "-o", tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    path = library_path()
    try:
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except Exception as e:  # no compiler: the callers fall back to Python
        stderr = getattr(e, "stderr", None)
        _build_error = f"{type(e).__name__}: {e}" + (
            f"\n{stderr.decode(errors='replace').strip()}" if stderr else "")
        print(f"[native] the native library could not be built ({_build_error}); "
              "tar shards are read by Python's tarfile, PNG rows by numpy, and JPEG "
              "files and zstd data raise", flush=True)
        return None
    i64, p = ctypes.c_int64, ctypes.c_void_p
    for name, args in (("tar_open", [ctypes.c_char_p]), ("tar_num_members", [i64]),
                       ("tar_member_name", [i64, i64, ctypes.c_char_p, i64]),
                       ("tar_member_size", [i64, i64]),
                       ("tar_read_member", [i64, i64, ctypes.POINTER(ctypes.c_uint8), i64]),
                       ("png_unfilter", [p, i64, i64, i64, p]),
                       ("jpeg_info", [p, i64, p, ctypes.c_char_p, i64]),
                       ("jpeg_decode", [p, i64, p, i64, ctypes.c_char_p, i64]),
                       ("zstd_content_size", [p, i64, ctypes.c_char_p, i64]),
                       ("zstd_decode", [p, i64, p, i64, ctypes.c_char_p, i64])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i64
    lib.crc32c.argtypes, lib.crc32c.restype = [p, i64], ctypes.c_uint32
    lib.tar_close.argtypes, lib.tar_close.restype = [i64], None
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _required(what: str) -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"{what} needs the native library, which could not be built "
                           f"({_build_error})")
    return lib


def _bytes(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else \
        np.ascontiguousarray(data).reshape(-1).view(np.uint8)


def png_unfilter(data: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """The raw rows (height, rowbytes) uint8 of a filtered PNG stream, by the
    native library (the caller checks native_available() first). Raises
    ValueError on a filter byte outside 0..4."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, rowbytes), np.uint8)
    code = _load().png_unfilter(src.ctypes.data, height, rowbytes, bpp, out.ctypes.data)
    if code != 0:
        raise ValueError(f"PNG row {-code - 1}: filter type {src[(-code - 1) * (rowbytes + 1)]} "
                         "is not one of 0..4")
    return out


def decode_jpeg(data: bytes, name: str = "<jpeg>") -> Tuple[np.ndarray, str]:
    """A baseline or progressive JPEG's pixels as Pillow 12.1.0 decodes them
    (libjpeg-turbo's defaults; jpeg_decode.cpp): (H, W) uint8 mode "L" or
    (H, W, 3) uint8 "RGB". A file the decoder does not take (arithmetic
    coding, 12-bit, lossless, CMYK / YCCK, other sampling factors) or a
    truncated one raises ValueError naming `name` and the feature; without
    the native library it raises RuntimeError."""
    lib = _required(f"{name}: JPEG")
    src = np.frombuffer(data, np.uint8)
    dims = np.zeros(3, np.int64)
    err = ctypes.create_string_buffer(256)
    if lib.jpeg_info(src.ctypes.data, src.size, dims.ctypes.data, err, 256) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    h, w, c = (int(v) for v in dims)
    out = np.empty((h, w, c) if c == 3 else (h, w), np.uint8)
    if lib.jpeg_decode(src.ctypes.data, src.size, out.ctypes.data, out.size, err, 256) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out, ("RGB" if c == 3 else "L")


def decode_zstd(data, out: Optional[np.ndarray] = None, name: str = "<zstd>") -> np.ndarray:
    """The content of one or more zstd frames (RFC 8878; skippable frames
    are passed over) as a uint8 array. `out`, a C-contiguous array of any
    dtype, takes the content in place and is returned (viewed as uint8);
    without it the array is allocated at the size the frames declare, or,
    when a frame does not declare its size, grown until the content fits.
    Content of another size than `out`, a corrupt frame, a failed content
    checksum or a frame that needs a dictionary raises ValueError naming
    `name`."""
    lib = _required(f"{name}: zstd")
    src = _bytes(data)
    err = ctypes.create_string_buffer(256)
    if out is not None:
        if not (out.flags.c_contiguous and out.flags.writeable):
            raise ValueError(f"{name}: `out` must be a writeable C-contiguous array")
        dst = out.reshape(-1).view(np.uint8)
        exact = True
    else:
        size = lib.zstd_content_size(src.ctypes.data, src.size, err, 256)
        if size == -1:
            raise ValueError(f"{name}: {err.value.decode()}")
        exact = size != -2
        dst = np.empty(size if exact else 4 * src.size + 65536, np.uint8)
    while True:
        n = lib.zstd_decode(src.ctypes.data, src.size, dst.ctypes.data, dst.size, err, 256)
        if n != -2 or exact:
            break
        dst = np.empty(2 * dst.size, np.uint8)  # no declared size: grow
    if n == -1:
        raise ValueError(f"{name}: {err.value.decode()}")
    if exact and n != dst.size:
        raise ValueError(f"{name}: the zstd content is "
                         f"{f'more than {dst.size}' if n == -2 else n} bytes, "
                         f"{dst.size} were expected")
    return dst if exact else dst[:n]


def crc32c(data) -> int:
    """The CRC-32C (Castagnoli) of a buffer, as OCDBT checks its files."""
    src = _bytes(data)
    return int(_required("CRC-32C").crc32c(src.ctypes.data, src.size))


class NativeTarFile:
    """Indexed random-access tar reader backed by the C++ library."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native tar reader unavailable: {_build_error}")
        self._lib = lib
        self._handle = lib.tar_open(path.encode())
        if self._handle < 0:
            raise IOError(f"cannot open tar {path}")
        self._names: Optional[List[str]] = None

    @property
    def names(self) -> List[str]:
        if self._names is None:
            n = self._lib.tar_num_members(self._handle)
            out = []
            buf = ctypes.create_string_buffer(4096)
            for i in range(n):
                ln = self._lib.tar_member_name(self._handle, i, buf, 4096)
                if ln >= 0:
                    out.append(buf.value.decode())
            self._names = out
        return self._names

    def read(self, index: int) -> bytes:
        size = self._lib.tar_member_size(self._handle, index)
        if size < 0:
            raise IndexError(index)
        buf = (ctypes.c_uint8 * size)()
        n = self._lib.tar_read_member(self._handle, index, buf, size)
        if n != size:
            raise IOError(f"short read {n} != {size}")
        return bytes(buf)

    def close(self):
        if self._handle >= 0:
            self._lib.tar_close(self._handle)
            self._handle = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def native_tar_samples(path: str) -> Iterator[Dict[str, bytes]]:
    """Members grouped by sample key ('000123.ext' or '000123.modality.ext',
    the webdataset convention), as data/datasets.py:_tar_samples groups
    them with tarfile."""
    with NativeTarFile(path) as tf:
        current_key = None
        current: Dict[str, bytes] = {}
        for i, name in enumerate(tf.names):
            base = os.path.basename(name)
            key, _, rest = base.partition(".")
            if current_key is not None and key != current_key:
                yield {"__key__": current_key, **current}
                current = {}
            current_key = key
            current[rest] = tf.read(i)
        if current_key is not None:
            yield {"__key__": current_key, **current}
