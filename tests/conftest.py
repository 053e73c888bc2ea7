"""Test harness config: force an 8-device virtual CPU mesh so multi-chip
sharding paths are exercised without TPU hardware (the reference tests
multi-node shuffle with mocked transports — SURVEY.md §4 tier 2; we test
multi-chip with virtual devices)."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

# some pytest plugins import jax before this conftest runs, freezing the
# platform choice from the outer env — force it again via config
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# conservative suite-wide watchdog: a GENUINE hang anywhere in tier-1
# fails fast with a diagnostic dump (thread stacks, semaphore holders,
# queue depths) instead of burning the 870s wall-clock budget.  The
# deadlines sit far above any legitimate no-progress gap on this CPU
# mesh (longest observed: cold XLA sort compiles, tens of seconds) and
# yield to EXPLICIT per-test conf settings (watchdog suite uses
# sub-second deadlines), so passing tests see no behavior change.
from spark_rapids_tpu.utils import watchdog as _W  # noqa: E402

_W.configure_global(task_timeout=420.0, collective_timeout=420.0,
                    compile_timeout=600.0, poll_interval=5.0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slowish: spawns subprocesses; slower than unit tier")
    config.addinivalue_line(
        "markers", "slow: scale-up workload tier (multi-batch + spill)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (CUDA kernels); skips "
        "without one")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _release_caches():
    """Drop every clearable executable/trace cache and return freed
    pages to the OS.  Compiled kernels + their jax-internal lowering
    artifacts measure ~5-10MB each on XLA:CPU; a full-suite run that
    never clears them was observed at 119GB RSS (thrashing the box)."""
    import ctypes
    import gc
    from spark_rapids_tpu.exec.base import clear_kernel_cache
    clear_kernel_cache()
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except Exception:
        pass


def _rss_mb() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") \
                // (1 << 20)
    except OSError:
        return 0


#: per-test RSS ceiling before caches are force-dropped mid-module (the
#: workload modules alone would otherwise grow past RAM)
RSS_CLEAR_MB = 6 << 10


@pytest.fixture(autouse=True)
def _bound_process_rss():
    yield
    if _rss_mb() > RSS_CLEAR_MB:
        _release_caches()


@pytest.fixture(autouse=True, scope="module")
def _bound_kernel_cache():
    """The process-global executable cache is sized for one workload's
    operator set; across the whole suite it would accumulate every
    module's executables (XLA:CPU clients segfault with thousands of
    live loaded executables).  Clearing per module keeps each module's
    hot-run reuse while bounding the live set."""
    yield
    _release_caches()
