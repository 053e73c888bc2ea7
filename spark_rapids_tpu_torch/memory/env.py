"""Executor-side resource environment: catalog + device->host->disk store
chain + spill handler install (port of spark_rapids_tpu/memory/env.py;
reference `GpuShuffleEnv.initStorage` `GpuShuffleEnv.scala:52-69`, which
wires RapidsDeviceMemoryStore -> RapidsHostMemoryStore -> RapidsDiskStore
and installs the RMM event handler).

The environment, its DeviceManager and its stores live on the device
they are given ("cuda" by default, which raises without a card).
"""
from __future__ import annotations

import threading
from typing import Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.vector import resolve_device
from spark_rapids_tpu_torch.memory.catalog import BufferCatalog
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.memory.stores import (DeviceMemoryStore,
                                                  DiskBlockManager,
                                                  DiskStore,
                                                  HostMemoryStore)


class ResourceEnv:
    _instance: Optional["ResourceEnv"] = None
    _lock = threading.Lock()

    def __init__(self, conf: Optional[C.RapidsConf] = None,
                 hbm_total: Optional[int] = None,
                 spill_dir: Optional[str] = None, device="cuda"):
        conf = conf or C.get_active_conf()
        self.conf = conf
        self.device = resolve_device(device)
        self.catalog = BufferCatalog()
        self.device_manager = DeviceManager.initialize(conf, hbm_total,
                                                       self.device)
        self.device_store = DeviceMemoryStore(
            self.catalog, self.device_manager, self.device)
        self.host_store = HostMemoryStore(conf[C.HOST_SPILL_STORAGE],
                                          self.catalog, self.device)
        self.disk_store = DiskStore(DiskBlockManager(spill_dir),
                                    self.catalog, self.device)
        self.device_store.set_spill_store(self.host_store)
        self.host_store.set_spill_store(self.disk_store)
        self.spill_callback = self.device_manager.install_spill_handler(
            self.device_store)
        self.semaphore = TpuSemaphore.initialize(
            conf[C.CONCURRENT_TPU_TASKS])

    @classmethod
    def init(cls, conf: Optional[C.RapidsConf] = None,
             hbm_total: Optional[int] = None,
             spill_dir: Optional[str] = None,
             device="cuda") -> "ResourceEnv":
        with cls._lock:
            if cls._instance is not None:
                cls._instance.close()
            DeviceManager.shutdown()
            cls._instance = cls(conf, hbm_total, spill_dir, device)
            return cls._instance

    @classmethod
    def get(cls, device=None) -> "ResourceEnv":
        """The process's environment, made on `device` if there is none
        yet (a device must then be given)."""
        with cls._lock:
            if cls._instance is None:
                if device is None:
                    raise ValueError(
                        "ResourceEnv: no environment yet, and no device "
                        "to make one on")
                DeviceManager.shutdown()
                cls._instance = cls(device=device)
            return cls._instance

    @classmethod
    def peek(cls) -> Optional["ResourceEnv"]:
        """The live environment WITHOUT constructing one."""
        with cls._lock:
            return cls._instance

    @classmethod
    def shutdown(cls) -> None:
        with cls._lock:
            if cls._instance is not None:
                cls._instance.close()
                cls._instance = None
            DeviceManager.shutdown()
            TpuSemaphore.shutdown()

    def close(self) -> None:
        for store in (self.device_store, self.host_store, self.disk_store):
            store.close()
