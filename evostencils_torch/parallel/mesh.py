"""Grids split by rows over a (dp, sp) device mesh (counterpart of
evostencils_tpu/parallel/mesh.py).

The reference pins the fine-grid state to `PartitionSpec("sp", None, ...)`
and lets XLA's SPMD partitioner add the halo collectives to every pad+shift
stencil sum.  PyTorch has no such partitioner (DTensor gathers a padded,
shifted slice of a sharded dimension), so the port writes out what XLA
derived:

  * the row split.  Rank q of the `sp` group owns the rows whose position
    (i + 1)·h lies in (q/k, (q+1)/k], k the `sp` size: 511 rows over 4
    ranks are 128/128/128/127, 31 rows 8/8/8/7.  Coarse row ci sits at the
    position of fine row c·(ci+1)−1, so the rule puts it on the rank that
    owns that fine row: restriction and prolongation need only a halo of
    the stencil's reach, never a gather;
  * the halo exchange (`halo_exchange`): rows above and below from the
    ranks that own them, zeros at the global Dirichlet boundary, by
    point-to-point transfers on the `sp` group;
  * global row offsets for every op that indexes by position (colour
    masks, block periods, injection);
  * all-reductions for every norm and inner product a host decision reads,
    and the maximum over all ranks of every measured time, so that every
    rank takes the same branches and breeds the same populations;
  * the replication rule: a level whose smallest slab would hold fewer
    than `replicate_below` rows is held whole by every rank.  The
    restriction into such a level gathers it, the prolongation out of it
    cuts this rank's rows again; those gathers are counted.

One process per rank (SPMD under torchrun).  NCCL serves ranks with one
card each; gloo serves the CPU and several ranks on one card (NCCL refuses
two ranks on one GPU).  gloo's send and recv do not take card tensors (its
TCP transport writes from the device pointer and the process aborts; torch
2.11 on an H100), so every gloo transfer of card tensors is staged through
host buffers (the "host" route).  The `dp` axis holds replicas:
`TorchProgramGenerator(mesh=...)` evaluates the same individual on every
`dp` row, as the reference's generator does with its state pinned to
P("sp", None); `batched_sharded_evaluation` gives each `dp` row its own
instances.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DIM_NAMES = ("dp", "sp")


def mesh_shape(n: int, dp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, sp) for n devices, the reference's factorisation: sp takes the
    larger factor nearest √n (8 → (2, 4)); an explicit dp must divide n."""
    if dp is None:
        sp = 1
        for candidate in range(int(np.sqrt(n)), 0, -1):
            if n % candidate == 0:
                sp = n // candidate
                break
        return n // sp, sp
    if n % dp != 0:
        raise ValueError(
            f"dp={dp} does not divide the device count {n}; "
            f"pick dp in {[d for d in range(1, n + 1) if n % d == 0]}"
        )
    return dp, n // dp


def build_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None):
    """A `DeviceMesh` with dims ("dp", "sp") over the ranks of the
    initialised process group, one device per rank; `n_devices` must be the
    world size.  Its device type follows the backend: "cuda" for NCCL,
    "cpu" for gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("build_mesh needs an initialised torch.distributed process group")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices on a process group of {world} ranks")
    shape = mesh_shape(n, dp)
    device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=DIM_NAMES)


def row_split(n_rows: int, parts: int):
    """[(lo, hi)] per part: part q owns rows i with (i+1)/(n+1) in
    (q/parts, (q+1)/parts]."""
    bounds = [min(q * (n_rows + 1) // parts, n_rows) for q in range(parts)] + [n_rows]
    return [(bounds[q], bounds[q + 1]) for q in range(parts)]


class RowSlab:
    """This rank's rows [lo, hi) of a grid of `global_shape`, split over the
    `sp` group of `layout`; `bounds[q]` are rank q's rows."""

    def __init__(self, layout: "MeshLayout", global_shape, bounds):
        self.layout = layout
        self.global_shape = tuple(global_shape)
        self.bounds = tuple(bounds)
        self.lo, self.hi = self.bounds[layout.sp_index]

    @property
    def rows(self) -> int:
        return self.hi - self.lo

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return (self.rows,) + self.global_shape[1:]

    def coarse_rows(self, factor: int) -> Tuple[int, int]:
        """The coarse rows [clo, chi) this rank owns by the position rule:
        those whose fine row factor·(ci+1)−1 lies in [lo, hi)."""
        n_coarse = (self.global_shape[0] + 1) // factor - 1
        return (min(-(-(self.lo + 1) // factor) - 1, n_coarse),
                min(-(-(self.hi + 1) // factor) - 1, n_coarse))

    def cut(self, x):
        """This rank's rows of a global array or tensor."""
        return x[self.lo:self.hi]

    def __repr__(self):
        return f"RowSlab({self.global_shape}, rows {self.lo}:{self.hi})"


class MeshLayout:
    """What one rank needs to run a cycle on slabs: its `sp` group, the
    row split of every grid shape, the replication rule and the collectives,
    with counts of what it sent (`counts`: "halo" exchanges, "gather"s of a
    level at the replication boundary, "host_gather"s of whole fields for
    the host, "all_reduce"s)."""

    def __init__(self, mesh, replicate_below: int = 64):
        if tuple(mesh.mesh_dim_names or ()) != DIM_NAMES:
            raise ValueError(f"mesh dims {mesh.mesh_dim_names}, expected {DIM_NAMES}")
        if replicate_below < 1:
            raise ValueError("replicate_below must be at least 1 row")
        self.mesh = mesh
        self.replicate_below = int(replicate_below)
        self.sp_group = mesh.get_group("sp")
        self.dp_group = mesh.get_group("dp")
        self.sp_ranks = dist.get_process_group_ranks(self.sp_group)
        self.dp_ranks = dist.get_process_group_ranks(self.dp_group)
        self.rank = dist.get_rank()
        self.sp_index = self.sp_ranks.index(self.rank)
        self.dp_index = self.dp_ranks.index(self.rank)
        self.sp_size = len(self.sp_ranks)
        self.dp_size = len(self.dp_ranks)
        self.backend = str(dist.get_backend(self.sp_group))
        self.counts = collections.Counter()
        self._slabs = {}

    # ---- the split ----

    def bounds(self, global_shape) -> list:
        return row_split(int(global_shape[0]), self.sp_size)

    def slab(self, global_shape) -> Optional[RowSlab]:
        """This rank's slab of a grid, or None where the grid is replicated
        (one rank in `sp`, or a slab below `replicate_below` rows)."""
        key = tuple(global_shape)
        if key not in self._slabs:
            bounds = self.bounds(key)
            sharded = self.sp_size > 1 and min(hi - lo for lo, hi in bounds) >= self.replicate_below
            self._slabs[key] = RowSlab(self, key, bounds) if sharded else None
        return self._slabs[key]

    def rows_of(self, global_shape) -> RowSlab:
        """This rank's rows of a grid by the split, sharded or not: the rows
        a restriction into a replicated level computes before its gather."""
        return RowSlab(self, global_shape, self.bounds(global_shape))

    def local_shape(self, global_shape) -> Tuple[int, ...]:
        slab = self.slab(global_shape)
        return tuple(global_shape) if slab is None else slab.local_shape

    # ---- transfers ----

    def route(self, device) -> str:
        """"device": the backend takes the tensors where they lie; "host":
        gloo with tensors on a card, staged through host buffers."""
        return "host" if "gloo" in self.backend and torch.device(device).type == "cuda" else "device"

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.route(t.device) == "host" else t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the `sp` group of a local (0-dim) partial sum."""
        self.counts["all_reduce"] += 1
        wire = self._wire(t.reshape(1)).clone()
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=self.sp_group)
        return wire.to(t.device).reshape(t.shape)

    def all_reduce_max(self, value: float, device) -> float:
        """The largest of every rank's `value` (all ranks of the mesh)."""
        self.counts["all_reduce"] += 1
        wire_device = device if self.route(device) == "device" and "nccl" in self.backend else "cpu"
        t = torch.tensor([float(value)], dtype=torch.float64, device=wire_device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def gather(self, t: torch.Tensor, slab: RowSlab, count: str = "gather") -> torch.Tensor:
        """The whole grid from every rank's rows of it (all-gather on the
        `sp` group, padded to the largest slab), counted under `count`."""
        self.counts[count] += 1
        rows = max(hi - lo for lo, hi in slab.bounds)
        local = self._wire(t.contiguous())
        if local.shape[0] < rows:
            pad = local.new_zeros((rows - local.shape[0],) + tuple(local.shape[1:]))
            local = torch.cat([local, pad])
        parts = [torch.empty_like(local) for _ in range(self.sp_size)]
        dist.all_gather(parts, local, group=self.sp_group)
        whole = torch.cat([p[:hi - lo] for p, (lo, hi) in zip(parts, slab.bounds)])
        return whole.to(t.device)


def halo_exchange(u: torch.Tensor, slab: RowSlab, reach: int) -> torch.Tensor:
    """u with `reach` rows above and below: global rows [lo−reach,
    hi+reach), taken from the ranks that own them and zero outside the grid
    (the homogeneous Dirichlet halo).  Every transfer is one contiguous
    block of rows, posted together by `batch_isend_irecv` on the `sp`
    group; a reach longer than a neighbour's slab reaches further ranks."""
    if reach <= 0:
        return u
    with torch.profiler.record_function("mesh.halo_exchange"):
        return _halo_exchange(u, slab, reach)


def _halo_exchange(u: torch.Tensor, slab: RowSlab, reach: int) -> torch.Tensor:
    layout = slab.layout
    layout.counts["halo"] += 1
    host = layout.route(u.device) == "host"
    u = u.contiguous()
    src = u.cpu() if host else u
    out = src.new_zeros((u.shape[0] + 2 * reach,) + tuple(u.shape[1:]))
    out[reach:reach + u.shape[0]] = src
    lo, hi = slab.lo, slab.hi
    ops = []
    for q, (qlo, qhi) in enumerate(slab.bounds):
        if q == layout.sp_index:
            continue
        peer = layout.sp_ranks[q]
        # What rank q needs from these rows, then what these rows need from
        # q: its rows above (tag 0), then below (tag 1).
        for tag, (a, b) in enumerate(((max(qlo - reach, lo), min(qlo, hi)),
                                      (max(qhi, lo), min(qhi + reach, hi)))):
            if a < b:
                ops.append(dist.P2POp(dist.isend, src[a - lo:b - lo], peer, layout.sp_group, tag))
        for tag, (a, b) in enumerate(((max(lo - reach, qlo), min(lo, qhi)),
                                      (max(hi, qlo), min(hi + reach, qhi)))):
            if a < b:
                start = a - (lo - reach)
                ops.append(dist.P2POp(dist.irecv, out[start:start + b - a], peer,
                                      layout.sp_group, tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.to(u.device) if host else out


def shard_state(state, layout: MeshLayout):
    """This rank's rows of each field of a global state (arrays or
    tensors); fields of a replicated grid stay whole."""
    out = []
    for x in state:
        slab = layout.slab(tuple(x.shape))
        out.append(x if slab is None else slab.cut(x))
    return tuple(out)


def gather_state(state, global_shapes, layout: MeshLayout):
    """The global fields of a state held in slabs (counted as
    "host_gather"s: whole fields leave the mesh)."""
    out = []
    for x, shape in zip(state, global_shapes):
        slab = layout.slab(tuple(shape))
        out.append(x if slab is None else layout.gather(x, slab, "host_gather"))
    return tuple(out)


def sharded_step(step: Callable, mesh, replicate_below: int = 64) -> Callable:
    """A global-in, global-out cycle on the mesh, the reference's wrapper:
    `step` comes from a `CycleLowering` built with this mesh and
    `replicate_below`, and runs on slabs; the wrapper cuts this rank's rows
    of (u, f), runs it and gathers the result."""
    layout = getattr(step, "layout", None)
    if layout is None or layout.mesh is not mesh or layout.replicate_below != replicate_below:
        raise ValueError(
            "the step must come from CycleLowering(..., mesh=mesh, "
            f"replicate_below={replicate_below}) on the same mesh")

    def wrapped(u, f, *args):
        shapes = [tuple(x.shape) for x in u]
        out = step(shard_state(u, layout), shard_state(f, layout), *args)
        return gather_state(out, shapes, layout)

    return wrapped


def batched_sharded_evaluation(step: Callable, mesh, residual_fn: Callable,
                               n_iterations: int) -> Callable:
    """The multi-device "training step" (reference `mesh.py:86-117`): a
    batch of problem instances split over `dp`, each instance split by rows
    over `sp`, advanced `n_iterations` cycles.

    `step(u, f)` runs on slabs (a `CycleLowering` on this mesh) and
    `residual_fn(u, f)` returns the instance's all-reduced residual norm.
    Returns run(u_batch, f_batch) over global batches (leading axis B, a
    multiple of the `dp` size) -> (u_out, residuals): u_out this rank's
    slabs of its `dp` row's instances, residuals all B norms on every
    rank."""
    layout = getattr(step, "layout", None)
    if layout is None or layout.mesh is not mesh:
        raise ValueError("the step must come from CycleLowering(..., mesh=mesh)")

    def run(u_batch, f_batch):
        batch = int(u_batch[0].shape[0])
        if batch % layout.dp_size:
            raise ValueError(f"batch {batch} is not a multiple of dp={layout.dp_size}")
        per_row = batch // layout.dp_size
        first = layout.dp_index * per_row
        u_out, residuals = [], []
        for i in range(first, first + per_row):
            u = shard_state(tuple(x[i] for x in u_batch), layout)
            f = shard_state(tuple(x[i] for x in f_batch), layout)
            for _ in range(n_iterations):
                u = step(u, f)
            u_out.append(u)
            residuals.append(residual_fn(u, f).reshape(1))
        local = torch.cat(residuals)
        wire = local.cpu() if "gloo" in str(dist.get_backend(layout.dp_group)) else local
        parts = [torch.empty_like(wire) for _ in range(layout.dp_size)]
        dist.all_gather(parts, wire, group=layout.dp_group)
        stacked = tuple(torch.stack([u[k] for u in u_out]) for k in range(len(u_out[0])))
        return stacked, torch.cat(parts).to(local.device)

    return run



def init_from_env(backend: str, timeout_s: float = 300.0, cpu: bool = False) -> None:
    """Initialise the default process group from torchrun's environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) unless the caller did, with
    `timeout_s` on every collective, so that a lost rank ends the run
    instead of hanging it.  On a card each process takes the card of its
    LOCAL_RANK (several ranks share a card under gloo)."""
    import datetime
    import os

    if not dist.is_initialized():
        dist.init_process_group(backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
