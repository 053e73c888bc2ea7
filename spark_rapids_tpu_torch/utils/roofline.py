"""The one roofline table every instrument judges against (port of
spark_rapids_tpu/utils/roofline.py).

The movement ledger's per-edge utilization (utils/movement.py) and
kernelprof's achieved-GFLOP/s / GB/s roofline percentages
(utils/kernelprof.py) both resolve their ceilings here, and every entry
is conf-overridable under ``spark.rapids.sql.profile.roofline.*``, so
an operator who probes real hardware sets the ceilings once.

Edge ceilings use the movement ledger's edge names (upload / readback /
spill / wire / collective); the compute side adds the device-memory
bandwidth ceiling and the peak-GFLOP/s ceiling the per-kernel roofline
join needs.  Defaults are NVIDIA H100 SXM5 datasheet figures (HBM3 3.35
TB/s, PCIe Gen5 x16 per direction, NVLink per direction, FP32 on CUDA
cores); each conf's doc names its datasheet line.
"""
from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch import config as C

#: movement-ledger edge name -> its roofline conf entry
_EDGE_CONFS = {
    "upload": C.ROOFLINE_UPLOAD_GBPS,
    "readback": C.ROOFLINE_READBACK_GBPS,
    "spill": C.ROOFLINE_SPILL_GBPS,
    "wire": C.ROOFLINE_WIRE_GBPS,
    "collective": C.ROOFLINE_COLLECTIVE_GBPS,
}

#: registry defaults, importable without a conf in hand (the movement
#: ledger's legacy NOMINAL_GBPS view aliases this)
DEFAULT_EDGE_GBPS = {edge: e.default for edge, e in _EDGE_CONFS.items()}


def _conf(conf: Optional[C.RapidsConf]) -> C.RapidsConf:
    return conf if conf is not None else C.get_active_conf()


def edge_gbps(edge: str, conf: Optional[C.RapidsConf] = None) -> float:
    """Bandwidth ceiling (GB/s) for one movement-ledger edge.  The
    legacy all-edges override (profile.movement.rooflineGBps, non-zero)
    wins over the per-edge entries so probed-hardware workflows that
    predate the shared table keep working."""
    conf = _conf(conf)
    override = float(conf[C.MOVEMENT_ROOFLINE_GBPS])
    if override > 0:
        return override
    entry = _EDGE_CONFS.get(edge)
    return float(conf[entry]) if entry is not None else 0.0


def edge_table(conf: Optional[C.RapidsConf] = None) -> dict:
    """{edge: ceiling GB/s} for every movement edge under `conf`."""
    return {edge: edge_gbps(edge, conf) for edge in _EDGE_CONFS}


def hbm_gbps(conf: Optional[C.RapidsConf] = None) -> float:
    """Device-memory bandwidth ceiling (GB/s) for the per-kernel
    memory-bound roofline fraction (analytic bytes / device time vs
    this)."""
    return float(_conf(conf)[C.ROOFLINE_HBM_GBPS])


def peak_gflops(conf: Optional[C.RapidsConf] = None) -> float:
    """Compute ceiling (GFLOP/s) for the per-kernel compute-bound
    roofline fraction."""
    return float(_conf(conf)[C.ROOFLINE_PEAK_GFLOPS])
