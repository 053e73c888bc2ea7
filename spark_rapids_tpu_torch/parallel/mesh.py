"""The device mesh (port of spark_rapids_tpu/parallel/mesh.py).

The reference runs a single controller over a `jax.sharding.Mesh` of
every visible device: one process owns all of them, and its "executors"
are slots of the mesh's data axis.  The port keeps that model: a `Mesh`
is an ordered tuple of `torch.device` slots under one axis name, and
this process drives every slot.  Collectives are done in the process:
copies between slots on different devices, and plain indexing where
slots share a device.

Slots spread round-robin over the visible devices.  Several slots on
one device are allowed only when asked for (`slots_per_device`), so one
card can run the lane's real routing, counts and gang code over a mesh
of four; a request beyond the visible devices times `slots_per_device`
raises, as the reference refuses to oversubscribe.  Slot i lives on
`devices[i]`; the mesh's home device, where outputs gather, is
`devices[0]`.
"""
from __future__ import annotations

import dataclasses
import functools
from contextlib import contextmanager
from typing import Optional

import torch

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of slot devices under one axis name.  Hashable:
    two meshes over the same slots and axis are equal."""
    devices: tuple
    axis_names: tuple = (DATA_AXIS,)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one slot")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> dict:
        """{axis name: slot count}, as `jax.sharding.Mesh.shape`."""
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    @functools.cached_property
    def groups(self) -> tuple:
        """((device, slot indices), ...): the slots of each physical
        device, devices in order of first appearance."""
        out: dict = {}
        for i, d in enumerate(self.devices):
            out.setdefault(d, []).append(i)
        return tuple((d, tuple(s)) for d, s in out.items())


def make_mesh(num_devices: Optional[int] = None,
              axis_name: str = DATA_AXIS, *, device="cuda",
              slots_per_device: int = 1) -> Mesh:
    """A mesh of `num_devices` slots (default: every visible device
    times `slots_per_device`) spread round-robin over the visible
    devices of `device`'s type: the cards torch sees, or the CPU as one
    device.  "cuda" without a card raises; pass device="cpu"."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass "
                "device='cpu' for a mesh of CPU slots")
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        visible = [torch.device("cpu")]
    else:
        raise ValueError(f"make_mesh: unsupported device {device}")
    if slots_per_device < 1:
        raise ValueError("make_mesh: slots_per_device must be >= 1")
    room = len(visible) * slots_per_device
    n = room if num_devices is None else int(num_devices)
    if n < 1:
        raise ValueError("make_mesh: num_devices must be >= 1")
    if n > room:
        raise ValueError(
            f"make_mesh(num_devices={n}) exceeds the {len(visible)} "
            f"visible {kind} device(s) x slots_per_device="
            f"{slots_per_device}: a silently truncated mesh would spread "
            f"the plan over fewer slots than the caller planned for.  "
            f"Request at most {room} slots, or ask for more slots per "
            f"device.")
    return Mesh(tuple(visible[i % len(visible)] for i in range(n)),
                (axis_name,))


def same_device(a, b) -> bool:
    """`a` and `b` name one device ("cuda" is the current card)."""
    def canon(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu") if d.type == "cpu" else d
    return canon(a) == canon(b)


@dataclasses.dataclass(frozen=True)
class SlotPlacement:
    """Where a stacked tensor's leading slot axis lives: split over the
    slots (`data_sharding`), or whole on every device (`replicated`)."""
    mesh: Mesh
    axis: Optional[str]

    @property
    def is_replicated(self) -> bool:
        return self.axis is None

    def put(self, t: torch.Tensor) -> list:
        """One chunk per device group of the mesh: the group's slots of
        `t` (all of `t` when replicated) on the group's device."""
        groups = self.mesh.groups
        if self.is_replicated:
            return [t.to(d, non_blocking=True) for d, _ in groups]
        if len(groups) == 1:
            return [t.to(groups[0][0], non_blocking=True)]
        return [t.index_select(0, torch.tensor(s, device=t.device))
                .to(d, non_blocking=True) for d, s in groups]

    def gather(self, chunks: list) -> torch.Tensor:
        """The inverse of `put` for a split placement: the chunks in slot
        order, on the home device."""
        groups = self.mesh.groups
        home = self.mesh.home
        if len(groups) == 1:
            return chunks[0].to(home, non_blocking=True)
        first = chunks[0]
        out = first.new_empty((self.mesh.size,) + tuple(first.shape[1:]),
                              device=home)
        for (_, slots), c in zip(groups, chunks):
            out[torch.tensor(slots, device=home)] = c.to(
                home, non_blocking=True)
        return out


# Placements are memoized per (mesh, axis), as the reference memoizes its
# NamedShardings: hot dispatch paths ask for the same one again and again.
@functools.lru_cache(maxsize=128)
def data_sharding(mesh: Mesh, axis_name: str = DATA_AXIS) -> SlotPlacement:
    """Leading-axis placement: element i of a stack lives on slot i."""
    return SlotPlacement(mesh, axis_name)


@functools.lru_cache(maxsize=128)
def replicated(mesh: Mesh) -> SlotPlacement:
    return SlotPlacement(mesh, None)


# --- the active mesh ---------------------------------------------------------
# The session-level switch of the mesh lanes: while a mesh is active, a
# hash exchange over as many partitions as slots runs the mesh all-to-all
# (shuffle/exchange.py) and, with spark.rapids.sql.spmd.enabled, a fused
# stage runs as one gang over the mesh (exec/spmd.py).

_ACTIVE: Optional[tuple] = None


def set_active_mesh(mesh: Optional[Mesh], axis_name: str = DATA_AXIS) -> None:
    global _ACTIVE
    _ACTIVE = None if mesh is None else (mesh, axis_name)


def get_active_mesh() -> Optional[tuple]:
    """(mesh, axis name) while a mesh is active, else None."""
    return _ACTIVE


@contextmanager
def active_mesh(mesh: Mesh, axis_name: str = DATA_AXIS):
    global _ACTIVE
    prev = _ACTIVE
    set_active_mesh(mesh, axis_name)
    try:
        yield mesh
    finally:
        _ACTIVE = prev
