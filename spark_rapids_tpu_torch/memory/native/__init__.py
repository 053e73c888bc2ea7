"""ctypes loader for the native host runtime (port of
spark_rapids_tpu/memory/native/__init__.py; runtime.cpp is a copy of the
reference's).

The shared library is compiled with g++ at first use into
`spark_rapids_tpu_torch/csrc/build/libruntime.so` (git-ignored), so a
fresh checkout builds it by itself; nothing is built at import.  The
native pieces are the analogs of the reference's in-JVM memory
bookkeeping (`AddressSpaceAllocator.scala`, `HashedPriorityQueue.java`)
plus a host staging arena standing in for the pinned memory pool
(`GpuDeviceManager.scala:243-249`) and CRC-framed spill files.

Each class keeps a pure-Python twin that runs when the library cannot be
built or loaded; `implementation()` says which one is live ("native" or
"python"), and the files both write are the same bytes.
"""
from __future__ import annotations

import ctypes
import heapq
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "csrc" / "build"
_SO = BUILD_DIR / "libruntime.so"

_lib = None
_lib_lock = threading.Lock()


#: the compiler's output of a failed build, for `implementation()`'s
#: callers to report
build_error: str = ""


def _compile() -> bool:
    global build_error
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp),
             str(_SRC)], capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_error = str(e)
        return False
    if proc.returncode:
        build_error = proc.stdout + proc.stderr
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, _SO)
    return True


def load_native():
    """Load (compiling if needed) the native runtime; None if unavailable."""
    global _lib, build_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not _SO.exists() or (
                _SO.stat().st_mtime < _SRC.stat().st_mtime):
            if not _compile():
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError as e:
            build_error = str(e)
            return None
        u64, i64, f64, p = (ctypes.c_uint64, ctypes.c_int64,
                            ctypes.c_double, ctypes.c_void_p)
        lib.asa_create.restype = p
        lib.asa_create.argtypes = [u64]
        lib.asa_destroy.argtypes = [p]
        lib.asa_allocate.restype = u64
        lib.asa_allocate.argtypes = [p, u64]
        lib.asa_free.restype = u64
        lib.asa_free.argtypes = [p, u64]
        for fn in ("asa_allocated", "asa_available", "asa_largest_free"):
            getattr(lib, fn).restype = u64
            getattr(lib, fn).argtypes = [p]
        lib.hpq_create.restype = p
        lib.hpq_destroy.argtypes = [p]
        lib.hpq_offer.argtypes = [p, i64, f64]
        lib.hpq_poll.restype = i64
        lib.hpq_poll.argtypes = [p]
        lib.hpq_peek.restype = i64
        lib.hpq_peek.argtypes = [p]
        lib.hpq_remove.restype = ctypes.c_int
        lib.hpq_remove.argtypes = [p, i64]
        lib.hpq_contains.restype = ctypes.c_int
        lib.hpq_contains.argtypes = [p, i64]
        lib.hpq_update_priority.argtypes = [p, i64, f64]
        lib.hpq_size.restype = u64
        lib.hpq_size.argtypes = [p]
        lib.arena_create.restype = p
        lib.arena_create.argtypes = [u64]
        lib.arena_destroy.argtypes = [p]
        lib.arena_write.argtypes = [p, u64, ctypes.c_char_p, u64]
        lib.arena_read.argtypes = [p, u64, ctypes.c_char_p, u64]
        lib.rt_crc32.restype = ctypes.c_uint32
        lib.rt_crc32.argtypes = [ctypes.c_char_p, u64]
        lib.spill_write.restype = i64
        lib.spill_write.argtypes = [ctypes.c_char_p, ctypes.c_char_p, u64]
        lib.spill_read_size.restype = i64
        lib.spill_read_size.argtypes = [ctypes.c_char_p]
        lib.spill_read.restype = i64
        lib.spill_read.argtypes = [ctypes.c_char_p, ctypes.c_char_p, u64]
        _lib = lib
        return _lib


def implementation() -> str:
    """"native" when the C++ runtime is built and loaded, else "python"
    (the pure-Python twins run)."""
    return "native" if load_native() is not None else "python"


_UNFIT = 2**64 - 1


class AddressSpaceAllocator:
    """First-fit address-space allocator (native-backed with Python
    fallback).  `allocate` returns an offset or None when it does not fit."""

    def __init__(self, size: int):
        self.size = size
        self._lib = load_native()
        if self._lib is not None:
            self._h = self._lib.asa_create(size)
            self._sizes = None
        else:
            self._h = None
            self._free: list[tuple[int, int]] = [(0, size)]  # (offset, size)
            self._sizes: dict[int, int] = {}
            self._lock = threading.Lock()

    def allocate(self, size: int):
        size = max(1, size)
        if self._h is not None:
            off = self._lib.asa_allocate(self._h, size)
            return None if off == _UNFIT else off
        with self._lock:
            for i, (off, sz) in enumerate(self._free):
                if sz >= size:
                    if sz > size:
                        self._free[i] = (off + size, sz - size)
                    else:
                        del self._free[i]
                    self._sizes[off] = size
                    return off
            return None

    def free(self, offset: int):
        if self._h is not None:
            sz = self._lib.asa_free(self._h, offset)
            return None if sz == _UNFIT else sz
        with self._lock:
            size = self._sizes.pop(offset, None)
            if size is None:
                return None
            self._free.append((offset, size))
            self._free.sort()
            merged = []
            for off, sz in self._free:
                if merged and merged[-1][0] + merged[-1][1] == off:
                    merged[-1] = (merged[-1][0], merged[-1][1] + sz)
                else:
                    merged.append((off, sz))
            self._free = merged
            return size

    @property
    def allocated(self) -> int:
        if self._h is not None:
            return self._lib.asa_allocated(self._h)
        with self._lock:
            return sum(self._sizes.values())

    @property
    def available(self) -> int:
        return self.size - self.allocated

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            try:
                self._lib.asa_destroy(self._h)
            except Exception:
                pass


_EMPTY = -2**63


class HashedPriorityQueue:
    """Priority queue with O(1) containment and priority update, keyed by
    int64 id; lowest priority polls first (spill candidate order)."""

    def __init__(self):
        self._lib = load_native()
        if self._lib is not None:
            self._h = self._lib.hpq_create()
        else:
            self._h = None
            self._heap: list[tuple[float, int, int]] = []
            self._entry: dict[int, tuple[float, int]] = {}
            self._seq = 0
            self._lock = threading.Lock()

    def offer(self, id_: int, priority: float) -> None:
        if self._h is not None:
            self._lib.hpq_offer(self._h, id_, priority)
            return
        with self._lock:
            self._seq += 1
            self._entry[id_] = (priority, self._seq)
            heapq.heappush(self._heap, (priority, self._seq, id_))

    def poll(self):
        if self._h is not None:
            v = self._lib.hpq_poll(self._h)
            return None if v == _EMPTY else v
        with self._lock:
            while self._heap:
                prio, seq, id_ = heapq.heappop(self._heap)
                if self._entry.get(id_) == (prio, seq):
                    del self._entry[id_]
                    return id_
            return None

    def peek(self):
        if self._h is not None:
            v = self._lib.hpq_peek(self._h)
            return None if v == _EMPTY else v
        with self._lock:
            while self._heap:
                prio, seq, id_ = self._heap[0]
                if self._entry.get(id_) == (prio, seq):
                    return id_
                heapq.heappop(self._heap)
            return None

    def remove(self, id_: int) -> bool:
        if self._h is not None:
            return bool(self._lib.hpq_remove(self._h, id_))
        with self._lock:
            return self._entry.pop(id_, None) is not None

    def __contains__(self, id_: int) -> bool:
        if self._h is not None:
            return bool(self._lib.hpq_contains(self._h, id_))
        with self._lock:
            return id_ in self._entry

    def update_priority(self, id_: int, priority: float) -> None:
        if self._h is not None:
            self._lib.hpq_update_priority(self._h, id_, priority)
            return
        self.remove(id_)
        self.offer(id_, priority)

    def __len__(self) -> int:
        if self._h is not None:
            return self._lib.hpq_size(self._h)
        with self._lock:
            return len(self._entry)

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            try:
                self._lib.hpq_destroy(self._h)
            except Exception:
                pass


class HostArena:
    """Host staging arena carved by an AddressSpaceAllocator — the pool the
    host memory store writes spilled device payloads into (pinned-pool
    analog; reference RapidsHostMemoryStore + PinnedMemoryPool)."""

    def __init__(self, size: int):
        self.size = size
        self.allocator = AddressSpaceAllocator(size)
        self._lib = load_native()
        if self._lib is not None:
            self._buf = self._lib.arena_create(size)
            if not self._buf:
                self._lib = None
        if self._lib is None:
            self._mem = bytearray(size)

    def write(self, offset: int, data: bytes) -> None:
        if self._lib is not None:
            self._lib.arena_write(self._buf, offset, bytes(data), len(data))
        else:
            self._mem[offset:offset + len(data)] = data

    def read(self, offset: int, n: int) -> bytes:
        if self._lib is not None:
            out = ctypes.create_string_buffer(n)
            self._lib.arena_read(self._buf, offset, out, n)
            return out.raw
        return bytes(self._mem[offset:offset + n])

    def __del__(self):
        if getattr(self, "_lib", None) is not None and \
                getattr(self, "_buf", None):
            try:
                self._lib.arena_destroy(self._buf)
            except Exception:
                pass


# ---------------------------------------------------------------------------
class SpillCorruptionError(IOError):
    """A CRC-framed spill file failed its integrity check."""


_SPILL_ERRORS = {-1: "cannot open", -2: "truncated header",
                 -3: "bad magic/version", -4: "payload size mismatch",
                 -5: "checksum mismatch"}


def spill_write(path: str, blob: bytes) -> None:
    """Write a spill file with CRC framing + fsync (native fast path;
    Python fallback writes the same format so files interoperate)."""
    lib = load_native()
    if lib is not None:
        rc = lib.spill_write(path.encode(), blob, len(blob))
        if rc != 0:
            raise IOError(f"spill write failed ({rc}) for {path}")
        return
    import struct
    import zlib
    crc = zlib.crc32(blob) & 0xFFFFFFFF
    with open(path, "wb") as f:
        f.write(b"TPUS" + struct.pack("<IQI", 1, len(blob), crc) + blob)
        f.flush()
        os.fsync(f.fileno())


def spill_read(path: str) -> bytes:
    """Read + verify a CRC-framed spill file; raises
    SpillCorruptionError on any integrity failure instead of handing
    poisoned bytes to the engine."""
    lib = load_native()
    if lib is not None:
        n = lib.spill_read_size(path.encode())
        if n < 0:
            raise SpillCorruptionError(
                f"spill file {path}: "
                f"{_SPILL_ERRORS.get(n, 'unreadable')}")
        buf = (ctypes.c_char * int(n))()
        rc = lib.spill_read(path.encode(), buf, int(n))
        if rc < 0:
            raise SpillCorruptionError(
                f"spill file {path}: {_SPILL_ERRORS.get(rc, 'bad')}")
        return bytes(buf)
    import struct
    import zlib
    with open(path, "rb") as f:
        hdr = f.read(20)
        if len(hdr) != 20 or hdr[:4] != b"TPUS":
            raise SpillCorruptionError(
                f"spill file {path}: bad magic/version")
        version, n, crc = struct.unpack("<IQI", hdr[4:])
        if version != 1:
            raise SpillCorruptionError(
                f"spill file {path}: bad magic/version")
        # a corrupted length field must not drive a huge allocation
        if n != os.path.getsize(path) - 20:
            raise SpillCorruptionError(
                f"spill file {path}: payload size mismatch")
        blob = f.read(n)
    if len(blob) != n:
        raise SpillCorruptionError(
            f"spill file {path}: payload size mismatch")
    if (zlib.crc32(blob) & 0xFFFFFFFF) != crc:
        raise SpillCorruptionError(f"spill file {path}: checksum mismatch")
    return blob
