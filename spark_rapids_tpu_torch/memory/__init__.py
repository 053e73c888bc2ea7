"""Device, memory & spill management (port of spark_rapids_tpu/memory).

Exports the tiered-store stack: BufferCatalog + device/host/disk stores with
native-backed (C++) allocator and spill-priority queue, the accounted
device-memory DeviceManager with preemptive-spill callback, and the task
TpuSemaphore.
"""
from spark_rapids_tpu_torch.memory.buffer import (  # noqa: F401
    BufferId, DegenerateBuffer, SpillableBuffer, StorageTier, TableMeta,
    degenerate_meta, meta_for_batch)
from spark_rapids_tpu_torch.memory.catalog import BufferCatalog  # noqa: F401
from spark_rapids_tpu_torch.memory.device_manager import (  # noqa: F401
    DeviceManager, SpillCallback)
from spark_rapids_tpu_torch.memory.env import ResourceEnv  # noqa: F401
from spark_rapids_tpu_torch.memory.retry import (  # noqa: F401
    TpuOutOfCoreError, TpuRetryOOM, TpuSplitAndRetryOOM, with_retry,
    with_split_retry)
from spark_rapids_tpu_torch.memory.semaphore import (  # noqa: F401
    TaskContext, TpuSemaphore)
from spark_rapids_tpu_torch.memory.stores import (  # noqa: F401
    DeviceMemoryStore, DiskBlockManager, DiskStore, HostMemoryStore)
