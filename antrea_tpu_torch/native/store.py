"""ConfigStore: ctypes binding for the native ovsdb_lite store.

The OVSDB seam of the reference, made native per SURVEY §2.5 ("in-process
config store with on-disk snapshot ... same transactional semantics"):
the C++ journaled KV store (native/ovsdb_lite.cc, this package's copy) holds
the durable config/state the reference keeps in ovsdb-server — cookie round
numbers, interface external-IDs, bridge config.  The library builds on
first use with g++ into antrea_tpu_torch/_build/ (git-ignored), named by a
hash of the source and the flags, so an edited source rebuilds and the
source's own directory is never written; environments without a toolchain
fall back to a pure-Python journal with the SAME record format, so the two
implementations (and the JAX package's store) are interchangeable on the
same file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import zlib
from typing import Optional

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "ovsdb_lite.cc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_CXX_FLAGS = ("-O2", "-shared", "-fPIC")
_MAGIC = 0x0A17DB01

_lib = None
_lib_err: Optional[str] = None


def _so_path() -> str:
    h = hashlib.sha256(open(_SRC, "rb").read())
    h.update(" ".join(_CXX_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"ovsdb_lite-{h.hexdigest()[:16]}.so")


def _build() -> Optional[str]:
    so = _so_path()
    if os.path.exists(so):
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(
            ["g++", *_CXX_FLAGS, "-o", tmp, _SRC],
            capture_output=True, text=True, timeout=120,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ unavailable: {e}"
    if r.returncode != 0:
        return f"g++ failed: {r.stderr[-500:]}"
    os.replace(tmp, so)
    return None


def _load():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return
    err = _build()
    if err is not None:
        _lib_err = err
        return
    try:
        lib = ctypes.CDLL(_so_path())
    except OSError as e:
        _lib_err = str(e)
        return
    lib.ovsdb_open.restype = ctypes.c_void_p
    lib.ovsdb_open.argtypes = [ctypes.c_char_p]
    lib.ovsdb_close.argtypes = [ctypes.c_void_p]
    lib.ovsdb_txn_set.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.ovsdb_txn_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ovsdb_txn_abort.argtypes = [ctypes.c_void_p]
    lib.ovsdb_commit.restype = ctypes.c_int
    lib.ovsdb_commit.argtypes = [ctypes.c_void_p]
    lib.ovsdb_get.restype = ctypes.c_int64
    lib.ovsdb_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.ovsdb_count.restype = ctypes.c_uint64
    lib.ovsdb_count.argtypes = [ctypes.c_void_p]
    lib.ovsdb_key_at.restype = ctypes.c_int64
    lib.ovsdb_key_at.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.ovsdb_compact.restype = ctypes.c_int
    lib.ovsdb_compact.argtypes = [ctypes.c_void_p]
    _lib = lib


def native_available() -> bool:
    _load()
    return _lib is not None


class _PyJournal:
    """Pure-Python fallback speaking the identical on-disk format."""

    def __init__(self, path: str):
        self.path = path
        self.table: dict[bytes, bytes] = {}
        self.staged: list[tuple[int, bytes, bytes]] = []
        if os.path.exists(path):
            self._replay()
        self._f = open(path, "ab")

    def _replay(self) -> None:
        data = open(self.path, "rb").read()
        off = 0
        while off + 12 <= len(data):
            magic, blen, crc = struct.unpack_from("<III", data, off)
            if magic != _MAGIC or off + 12 + blen > len(data):
                break
            body = data[off + 12: off + 12 + blen]
            if zlib.crc32(body) != crc:
                break
            self._apply(body)
            off += 12 + blen
        # torn/corrupt tail records are dropped, matching the C++ replay

    def _apply(self, body: bytes) -> None:
        o = 0
        (nops,) = struct.unpack_from("<I", body, o); o += 4
        for _ in range(nops):
            kind = body[o]; o += 1
            (klen,) = struct.unpack_from("<I", body, o); o += 4
            key = body[o:o + klen]; o += klen
            if kind == 0:
                (vlen,) = struct.unpack_from("<I", body, o); o += 4
                val = body[o:o + vlen]; o += vlen
                self.table[key] = val
            else:
                self.table.pop(key, None)

    def _encode(self, ops) -> bytes:
        body = struct.pack("<I", len(ops))
        for kind, key, val in ops:
            body += bytes([kind]) + struct.pack("<I", len(key)) + key
            if kind == 0:
                body += struct.pack("<I", len(val)) + val
        return body

    def commit(self) -> bool:
        if not self.staged:
            return True
        body = self._encode(self.staged)
        rec = struct.pack("<III", _MAGIC, len(body), zlib.crc32(body)) + body
        self._f.write(rec)
        self._f.flush()
        for kind, key, val in self.staged:
            if kind == 0:
                self.table[key] = val
            else:
                self.table.pop(key, None)
        self.staged.clear()
        return True

    def compact(self) -> bool:
        ops = [(0, k, v) for k, v in sorted(self.table.items())]
        body = self._encode(ops)
        rec = struct.pack("<III", _MAGIC, len(body), zlib.crc32(body)) + body
        tmp = self.path + ".compact"
        with open(tmp, "wb") as f:
            f.write(rec)
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        return True

    def close(self) -> None:
        self._f.close()


class ConfigStore:
    """Transactional KV store over the native lib (Python fallback kept
    wire-compatible).  Usage: stage set()/delete() then commit()."""

    def __init__(self, path: str, force_python: bool = False):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._py: Optional[_PyJournal] = None
        self._h = None
        if not force_python:
            _load()
        if not force_python and _lib is not None:
            h = _lib.ovsdb_open(path.encode())
            if not h:
                raise OSError(f"ovsdb_lite: cannot open {path}")
            self._h = ctypes.c_void_p(h)
        else:
            self._py = _PyJournal(path)

    @property
    def backend(self) -> str:
        return "native" if self._h is not None else "python"

    def set(self, key: str, value: bytes) -> None:
        if self._h is not None:
            _lib.ovsdb_txn_set(self._h, key.encode(), value, len(value))
        else:
            self._py.staged.append((0, key.encode(), value))

    def delete(self, key: str) -> None:
        if self._h is not None:
            _lib.ovsdb_txn_delete(self._h, key.encode())
        else:
            self._py.staged.append((1, key.encode(), b""))

    def abort(self) -> None:
        if self._h is not None:
            _lib.ovsdb_txn_abort(self._h)
        else:
            self._py.staged.clear()

    def commit(self) -> None:
        ok = (_lib.ovsdb_commit(self._h) == 1) if self._h is not None \
            else self._py.commit()
        if not ok:
            raise OSError("ovsdb_lite: commit failed")

    def get(self, key: str) -> Optional[bytes]:
        if self._h is not None:
            buf = ctypes.create_string_buffer(1 << 16)
            n = _lib.ovsdb_get(self._h, key.encode(), buf, len(buf))
            if n < 0:
                return None
            if n > len(buf):  # value larger than the probe buffer
                buf = ctypes.create_string_buffer(n)
                n = _lib.ovsdb_get(self._h, key.encode(), buf, n)
            return buf.raw[:n]
        return self._py.table.get(key.encode())

    def keys(self) -> list[str]:
        if self._h is not None:
            out = []
            n = _lib.ovsdb_count(self._h)
            buf = ctypes.create_string_buffer(1 << 12)
            for i in range(n):
                k = _lib.ovsdb_key_at(self._h, i, buf, len(buf))
                if k >= 0:
                    out.append(buf.raw[:k].decode())
            return out
        return sorted(k.decode() for k in self._py.table)

    def compact(self) -> None:
        ok = (_lib.ovsdb_compact(self._h) == 1) if self._h is not None \
            else self._py.compact()
        if not ok:
            raise OSError("ovsdb_lite: compact failed")

    def close(self) -> None:
        if self._h is not None:
            _lib.ovsdb_close(self._h)
            self._h = None
        elif self._py is not None:
            self._py.close()
            self._py = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
