"""Build and load the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` has a plain C interface and compiles with `nvcc`
alone into `csrc/build/lib<name>.so` (no PyTorch headers, so a build takes
seconds), which is loaded with `ctypes`.  Builds happen at first use:
`build()` starts one `nvcc` per stale source, all at once, and waits for
them; `function()` builds what it needs and returns a ctypes function with
its argument types declared.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

log = logging.getLogger("spark_rapids_tpu_torch.cuda_build")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("q1_fused", "grouped_sum", "window_group_sums")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
#: poll granularity of a build waiter (cancellation and its deadline)
_POLL_S = 0.05
_LIBS: dict = {}
_FNS: dict = {}  # (source, symbol) -> loaded ctypes function
#: [nvcc builds, their wall nanoseconds] since start (telemetry)
_BUILD_STATS = [0, 0]


def loaded_count() -> int:
    """Kernel libraries loaded in this process."""
    return len(_LIBS)


def build_count() -> int:
    return _BUILD_STATS[0]


def build_ms() -> float:
    return _BUILD_STATS[1] / 1e6


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled with the CUDA "
        "toolkit's nvcc (put it on PATH or set CUDA_HOME)")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = lib_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build(names=SOURCES) -> dict:
    """Compile the stale sources among `names`, one nvcc process each,
    all started together.  Returns {name: compiler output} for what was
    built; raises with the compiler's output if any build fails."""
    from spark_rapids_tpu_torch.utils import watchdog as W
    if not any(_stale(n) for n in names):
        return {}
    # single flight: one thread builds while the others wait, but a
    # waiter whose peer's build outlives the compile deadline builds
    # itself (a benign double build) instead of waiting on a wedge
    deadline = time.monotonic() + W.deadline_for("compile")
    locked = _LOCK.acquire(timeout=_POLL_S)
    while not locked and time.monotonic() < deadline:
        W.check_cancelled()
        locked = _LOCK.acquire(timeout=_POLL_S)
    try:
        todo = [n for n in names if _stale(n)]
        if not todo:
            return {}
        if not locked:
            log.warning("kernel build of %s waited past the compile "
                        "deadline on another thread's build; building "
                        "here", todo)
        # the builds are watched under the compile deadline; the
        # "compile" hang site stands for the reference's XLA compile.  A
        # profiled query records the build as a compile span, and with
        # kernel attribution on its time is charged to the kernels built
        from spark_rapids_tpu_torch.utils import profile as P
        label = f"compile:{','.join(todo)}"
        with W.heartbeat(label, kind="compile"), \
                P.span(label, cat=P.CAT_COMPILE):
            W.maybe_hang("compile")
            t0 = time.perf_counter_ns()
            try:
                return _run_nvcc(todo)
            finally:
                record_builds(todo, time.perf_counter_ns() - t0)
    finally:
        if locked:
            _LOCK.release()


def record_builds(names, ns: int) -> None:
    """Count the builds of `names`, which took `ns` nanoseconds in all,
    and with kernel attribution on charge each its share."""
    from spark_rapids_tpu_torch.utils import kernelprof as KP
    _BUILD_STATS[0] += len(names)
    _BUILD_STATS[1] += ns
    if KP.enabled():
        for n in names:
            KP.note_build(n, ns // len(names))


def _run_nvcc(todo: list) -> dict:
    """Run one nvcc per source of `todo` at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / (f"lib{n}.so.{os.getpid()}."
                           f"{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT,
                                     text=True), tmp)
    logs, failed = {}, []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode:
            failed.append(f"nvcc failed for {n}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def function(name: str, symbol: str, argtypes: list,
             restype=ctypes.c_int):
    """The C function `symbol` of `csrc/<name>.cu`, built and loaded on
    first use, with `argtypes` declared (pointers and the stream as
    c_void_p, so ctypes never cuts them to 32 bits).  Later calls return
    the same function object."""
    fn = _FNS.get((name, symbol))
    if fn is not None:
        return fn
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    _FNS[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")
