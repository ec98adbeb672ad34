"""Multi-process execution over ``torch.distributed``.

Counterpart of the multi-host half of ``repro.launch.mesh``:

* :func:`init_distributed` starts a gloo process group (the JAX package
  starts ``jax.distributed`` with gloo CPU collectives);
* :func:`make_camr_mesh` gives this process's block of the ``K`` virtual
  CAMR workers, process-major: rank ``r`` of ``world`` owns workers
  ``[r*K/world, (r+1)*K/world)``, the class-major host-block order of
  ``Topology.host_of`` (the global device order of a JAX mesh over
  processes). :func:`repro_torch.core.collective.camr_shuffle` takes the
  result as ``mesh=`` and runs its process lane;
* :func:`detect_topology` and :func:`host_membership` read the process
  layout as the JAX functions do.

One card cannot hold two NCCL ranks, so the group is gloo, and the
shuffle's process lane moves its cross-process rows through host buffers.

The production meshes of the JAX module are here too:
:func:`make_production_mesh` gives a
:class:`~torch.distributed.device_mesh.DeviceMesh` of shape ``(16,
16)`` (``("data", "model")``, 256 devices) or ``(2, 16, 16)`` (``("pod",
"data", "model")``, 512), :func:`data_axes` the axes that carry the
batch and :func:`mesh_devices` its size. The mesh spans the default
process group, which the caller starts: :func:`fake_group` (every
collective a no-op; the dry run traces rank 0's step on ``meta`` over it
and ``chip_smoke.py`` runs the same rank's step on one card), a real
group of that size, or, in the tests, a fake group under
``torch.distributed._local_tensor.LocalTensorMode``, which simulates
every rank of a small mesh in one process with real values.

Two processes on one machine, each run with its rank::

    from repro_torch.core.collective import camr_shuffle, make_plan
    from repro_torch.launch.mesh import init_distributed, make_camr_mesh
    assert init_distributed(coordinator="localhost:29512",
                            num_processes=2, process_id=rank)
    mesh = make_camr_mesh(8)              # (q, k) = (2, 4): 4 workers each
    out = camr_shuffle(make_plan(2, 4, d), contribs[mesh.lo:mesh.hi],
                       mesh=mesh)         # contribs [8, 4, 3, 8, d]
"""

from __future__ import annotations

import contextlib
import datetime
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..core.schedule import Topology
from ..device import resolve_device

__all__ = ["make_production_mesh", "data_axes", "mesh_devices",
           "fake_group", "CAMRMesh", "init_distributed", "make_camr_mesh",
           "detect_topology", "host_membership"]

#: how long a collective of the group may wait for its peers
TIMEOUT = datetime.timedelta(seconds=300)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """Single pod: (16, 16) ('data', 'model') = 256 devices. Multi-pod:
    (2, 16, 16) ('pod', 'data', 'model') = 512; the 'pod' axis carries
    only data parallelism and the cross-pod gradient reduction, never
    layer-internal collectives. The mesh's devices are the ranks ``0 ..
    n-1`` of the default process group, which must be up and hold
    exactly ``n`` ranks; ``device_type`` is where each rank's tensors
    live (``"cpu"`` for tensors on the CPU or on ``meta``, ``"cuda"`` on
    a card)."""
    from torch.distributed.device_mesh import DeviceMesh
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a mesh of {n} devices needs a default process "
                           f"group of {n} ranks (see fake_group)")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def data_axes(mesh) -> tuple[str, ...]:
    """Mesh axes carrying the batch dimension."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def mesh_devices(mesh) -> int:
    return mesh.size()


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A default process group of ``world_size`` ranks in which this
    process is ``rank`` and every collective returns at once without
    touching its output: what one process needs to run one rank's
    program of a mesh it does not have (JAX's dry run compiles for 512
    fake host devices instead). Destroyed on exit; refused when a group
    is already up (the group is process-wide state)."""
    # torch ships the store the "fake" backend needs only in its testing
    # package; the backend itself is public (torch.distributed registers
    # it), and the store holds no state that a run reads back
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def init_distributed(*, coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Start a gloo ``torch.distributed`` group.

    ``coordinator`` is ``host:port`` of rank 0 (``tcp://``); without it
    the group starts from the environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). Returns True once this
    process is in a group of more than one process, False when gloo is
    unavailable or the start-up fails (a caller may run the
    single-process lane instead; ``chip_smoke.py`` fails on it). A group
    that is already up is reported as it is.
    """
    if not dist.is_available() or not dist.is_gloo_available():
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    init = f"tcp://{coordinator}" if coordinator else "env://"
    try:
        dist.init_process_group(
            "gloo", init_method=init,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id, timeout=TIMEOUT)
    except (RuntimeError, ValueError, OSError):
        return False
    return dist.get_world_size() > 1


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclass(frozen=True)
class CAMRMesh:
    """This process's place on the 1-D CAMR worker axis: ``K`` workers
    over the ``world`` processes of the default group, this one ``rank``,
    owning the workers ``range(lo, hi)``; ``device`` where this process's
    tensors live."""
    K: int
    world: int
    rank: int
    device: torch.device

    @property
    def K_local(self) -> int:
        return self.K // self.world

    @property
    def lo(self) -> int:
        return self.rank * self.K_local

    @property
    def hi(self) -> int:
        return self.lo + self.K_local

    @property
    def workers(self) -> range:
        return range(self.lo, self.hi)


def make_camr_mesh(K: int, *, device=None) -> CAMRMesh:
    """This process's block of the ``K`` CAMR workers over the processes
    of the default group (one process when none is up), process-major.
    Raises when the world size does not divide ``K``."""
    world, rank = _world()
    if K % world:
        raise ValueError(f"{world} processes cannot split {K} CAMR "
                         "workers into equal blocks")
    return CAMRMesh(K=K, world=world, rank=rank, device=resolve_device(device))


def detect_topology(k: int, *, alpha: float = 4.0) -> Topology:
    """Topology implied by the process layout: ``world`` hosts when that
    divides ``k`` (two-level, class-major blocks), else flat. ``alpha``
    is the modeled inter/intra cost ratio of the per-edge accounting; it
    never changes the executed values."""
    hosts, _ = _world()
    if hosts > 1 and k % hosts == 0:
        return Topology.two_level(hosts, alpha=alpha)
    return Topology.flat()


def host_membership(q: int, k: int, *, alpha: float = 4.0,
                    max_failed_hosts: int | None = None):
    """The fault-domain tracker of this process layout, or None when the
    layout is flat (no host blocks to lose); feed ``kill_host`` /
    ``current_topology`` into ``ShuffleStream.set_topology``."""
    from ..runtime.fault import HostMembership
    topo = detect_topology(k, alpha=alpha)
    if topo.is_flat:
        return None
    return HostMembership(q, k, topo, max_failed_hosts=max_failed_hosts)
