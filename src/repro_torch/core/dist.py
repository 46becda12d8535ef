"""The model ring's collectives over a ``torch.distributed`` process group.

The port of the JAX package's ``core/dist.py``.  There the whole model
step runs inside one ``shard_map`` and :class:`AxisEnv` carries the mesh
axis names visible inside it.  Here each rank of the ring is a process
running the same body on its own shards, and ``AxisEnv.model`` is the
rank's :class:`Ring`: its process group, rank, size and device.  Every
collective the models make goes through this module, with the
reference's names and semantics (``ppermute`` over (source,
destination) pairs, tiled ``all_gather`` on the last dim, ``psum``,
``psum_scatter``, ``pmax``, ``pmean``, ``axis_index``, untiled
``all_to_all``), each optionally
confined to the sub-ring groups of :class:`repro_torch.core.rings.
RingConfig` (``groups=``).  No other module of the port calls
``torch.distributed``.

The backend is chosen by one rule (:func:`backend_for`) from where the
ranks live, which the caller states (:func:`rank_devices`): a card per
rank, or the CPU or one shared card.

* **NCCL, a card per rank** (rank r on ``cuda:r``).  A collective takes
  the rank's device tensors as they are: no staging copy, no host
  synchronisation.  It runs on NCCL's stream after the compute stream's
  producer of its input, and its result is ordered before the compute
  stream's next use (``Pending.wait()`` for an asynchronous hop), so an
  ESL hop runs on the link while the next chunk's product runs on the
  compute stream, and a collective can be captured in a CUDA graph.
  ``ppermute`` is one ``batch_isend_irecv`` of its pairs; every other
  collective is one ``all_gather_into_tensor`` over its group (each
  rank's part to every peer at once), the reduction folded on the
  device (``psum_scatter`` gathers the whole tensors and each rank
  folds its own block: tp times a reduce-scatter's bytes, which at the
  engine's sizes cost the link's latency, not its rate).  Every
  communicator is made and used once when the ring starts (the default
  group's, each sub-ring's in :meth:`Ring.make_groups`), with the P2P
  pairs of the ring's rotations: a communicator or a link connected
  lazily inside a capture breaks the capture.
* **gloo, the CPU or one shared card.**  gloo takes no CUDA tensor for
  send/recv, so on the card every collective stages its tensor through
  a pinned host buffer, here and only here: a device-to-host copy (which
  waits for the tensor's producer), the host collective, and an
  asynchronous host-to-device copy of the result.  On the CPU the same
  code runs without the staging copies.  Each collective is one round
  of point-to-point sends and receives between the ranks of its group
  (each rank sends its part to every peer at once): gloo's own
  all-reduce of a small tensor took ~1 ms between two processes on one
  card's host, twice a send/receive pair.  Its collectives cannot be
  captured, so a gloo ring's steps run eagerly.

A world of ranks splits into disjoint sub-rings (:meth:`Ring.split`,
the mesh fleet's): each rank gets a :class:`SubRing`, a handle whose
``rank`` and ``size`` are its place in its sub-ring, whose ``group`` is
the sub-ring's process group and whose P2P peers map to world ranks, so
the models' collectives run on it unchanged and never leave the
sub-ring.  A ``("data", "model")`` grid of ``dwidth * tp`` ranks
(rank ``l = d * tp + m``, model innermost) splits the world twice
(:func:`grid_rings`): each rank's model sub-ring runs the ESL ring's
collectives, its data sub-ring the data axis's (the batch rows'
gather, the KV sequence's ``pmax``/``psum``, the giant MoE's
:func:`all_to_all`).  Host decisions that several processes must make
alike go through :class:`Agreement`: picklable objects over a gloo group of the
whole world made for them alone (also under NCCL), never through the
model's communicators and never inside a capture.

On both, every reduction is one round of swaps that then folds the parts
in rank order, so every rank holds the same bits, and an NCCL ring
computes the bits a gloo ring computes.  ``Ring.counters`` counts what
the collectives did; a replay of a captured program adds its capture's
collectives, hops and bytes back (:func:`held_counters`,
:meth:`Ring.add_counters`), as :func:`repro_torch.kernels.held_launches`
does for launches.

:func:`run_ranks` spawns the ranks (start method ``spawn``, never
``fork``: the parent may have CUDA up), meets them through a
``FileStore`` in a temporary directory (no TCP port, so concurrent test
workers cannot collide) and returns rank 0's result; a rank that fails
fails the run.

Under autograd (the train step) every collective is differentiable
through a ``torch.autograd.Function`` whose backward is its adjoint:
``all_gather`` -> ``psum_scatter``, ``psum_scatter`` -> ``all_gather``,
``psum`` -> ``psum``, ``pmean`` -> ``pmean``, ``ppermute`` -> the
inverse permutation, ``all_to_all`` -> itself; ``pmax`` (only a
stop-gradient shift) returns a detached value.  A rank's gradient of a
value replicated over a ring is then its share of the whole, and the
shares add to the gradient of the objective when each rank seeds its
copy of the (replicated) loss with ``1 / ranks``: the objective is
counted once (:func:`repro_torch.core.steps.build_train_step`).  Every
rank runs the same backward graph, so the backward's collectives come
in the same order on every rank.  Without grad the plain collectives
run, unchanged.

With ``model=None`` every helper is the identity and the same model
code runs on one device.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import sys
import tempfile
import time
import traceback
import weakref
from dataclasses import dataclass
from datetime import timedelta
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch

Groups = Optional[Sequence[Sequence[int]]]

# counters a replay adds back (``seconds`` is host time inside the
# collective calls, which a replay makes none of)
REPLAYED = ("collectives", "hops", "staged_bytes")


class Ring:
    """One rank's handle on the model ring: the default process group
    (``group`` None in every call), this process's rank and the ring's
    size, the device its tensors live on, the backend, sub-ring groups
    (:meth:`make_groups`), and counters of what the collectives did
    (``collectives`` calls, ``hops`` of ppermute, ``staged_bytes``
    copied through host memory, ``seconds`` of host time spent inside
    them).  On NCCL the ring's communicator and the P2P links of its two
    rotations are made and used once here."""

    def __init__(self, device):
        import torch.distributed as dist
        self.group = None
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = str(dist.get_backend())
        self.device = torch.device(device)
        self._subgroups: Dict[tuple, Any] = {}
        self._gathered: Dict[tuple, tuple] = {}
        self._splits: Dict[tuple, "SubRing"] = {}
        self._agreement: Optional["Agreement"] = None
        self.counters = dict(collectives=0, hops=0, staged_bytes=0,
                             seconds=0.0)
        self.traffic: Dict[str, Tuple[int, int]] = {}
        if self.nccl:
            self._warm_up(None, [list(range(self.size))])

    def peer(self, r: int) -> int:
        """The world rank of this ring's rank ``r``: the peer
        ``torch.distributed`` takes in a point-to-point call, whatever
        the group."""
        return r

    def split(self, groups: Sequence[Sequence[int]]) -> "SubRing":
        """The handle of the sub-ring of ``groups`` (disjoint lists of
        this ring's ranks covering it) that holds this rank.  Every rank
        calls this at the same point: each group's process group is made
        by every rank, in order (``new_group`` is collective over the
        world), and each sub-ring then warms its own communicator.  Made
        once per ``groups``; never inside a capture."""
        key = tuple(tuple(int(r) for r in g) for g in groups)
        got = self._splits.get(key)
        if got is not None:
            return got
        seen = sorted(r for g in key for r in g)
        if seen != list(range(self.size)):
            raise ValueError(f"sub-rings {key} do not split a ring of "
                             f"{self.size} ranks into disjoint groups")
        if self.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"sub-rings {key} made inside a CUDA graph "
                               "capture")
        import torch.distributed as dist
        mine = None
        for g in key:
            pg = dist.new_group([self.peer(r) for r in g],
                                backend=self.backend)
            if self.rank in g:
                mine = (g, pg)
        sub = SubRing(self, mine[0], mine[1])
        self._splits[key] = sub
        return sub

    def agreement(self) -> "Agreement":
        """The world's :class:`Agreement` (made at first use: every rank
        calls this at the same point)."""
        if self._agreement is None:
            self._agreement = Agreement(self)
        return self._agreement

    @property
    def nccl(self) -> bool:
        return self.backend == "nccl"

    @property
    def staged(self) -> bool:
        """Whether collectives stage through host memory (gloo on a
        card)."""
        return not self.nccl and self.device.type == "cuda"

    def reset_counters(self) -> None:
        for k in self.counters:
            self.counters[k] = 0
        self.traffic.clear()

    def _traffic(self, kind: str, received: float) -> None:
        """Count one collective of ``kind`` and the bytes this rank
        received in it (``traffic[kind] = (calls, bytes)``, a new tuple
        each time, so a copy of the dict is a snapshot; a warm-up counts
        too)."""
        calls, got = self.traffic.get(kind, (0, 0))
        self.traffic[kind] = (calls + 1, got + int(received))

    def add_counters(self, made: Dict[str, float]) -> None:
        """Add a replayed capture's collectives, hops and bytes."""
        for k in REPLAYED:
            self.counters[k] += made.get(k, 0)

    def gather_object(self, obj) -> List[Any]:
        """Every rank's ``obj``, in rank order, on every rank."""
        import torch.distributed as dist
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def make_groups(self, groups: Sequence[Sequence[int]]) -> None:
        """Make the sub-ring process groups ``groups`` (every rank calls
        this at the same point: ``new_group`` is collective) and, on
        NCCL, use each one and the P2P pairs of its rotations once."""
        key = tuple(tuple(int(r) for r in g) for g in groups)
        if key in self._subgroups:
            return
        if self.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"sub-ring groups {key} made inside a CUDA graph capture: a "
                "communicator made there breaks the capture; call "
                "ring.make_groups(...) before the first capture")
        import torch.distributed as dist
        self._subgroups[key] = [
            (dist.new_group([self.peer(r) for r in g],
                            backend=self.backend), list(g))
            for g in key]
        if self.nccl:
            self._warm_up(groups, [list(g) for g in key])

    def _warm_up(self, groups: Groups, rings: List[List[int]]) -> None:
        """One all-gather of ``groups`` and a hop each way around every
        ring of ``rings``, then a synchronisation: the communicator and
        the links exist before any capture.  Counts nothing."""
        x = torch.zeros(1, device=self.device)
        with held_counters(self):
            all_gather(x, self, groups=groups)
            for up in (1, -1):
                perm = [(g[i], g[(i + up) % len(g)]) for g in rings
                        for i in range(len(g))]
                ppermute(x, self, perm)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _group(self, groups: Groups):
        """(process group, its ranks) of the sub-ring holding this rank;
        the whole ring without ``groups``.  Every rank reaches the same
        collectives in the same order, so each creates the sub-ring
        groups at the same point."""
        if groups is None:
            return self.group, list(range(self.size))
        key = tuple(tuple(int(r) for r in g) for g in groups)
        self.make_groups(key)
        for pg, ranks in self._subgroups[key]:
            if self.rank in ranks:
                return pg, ranks
        raise ValueError(f"rank {self.rank} is in no group of {groups}")

    # -- host staging (the one place a CUDA tensor meets gloo) ---------

    def _stage_in(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor a collective sends: on a gloo ring on the card a
        pinned host copy (the device-to-host copy waits for ``x``'s
        producer); otherwise ``x`` itself."""
        x = x.detach()
        if self.staged:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            self.counters["staged_bytes"] += host.numel() * host.element_size()
            return host
        return x.contiguous()

    def _buffer(self, shape, dtype) -> torch.Tensor:
        """A collective's receive buffer: pinned host memory on a gloo
        ring on the card, the ring's device otherwise."""
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _stage_out(self, out: torch.Tensor, t0: float) -> torch.Tensor:
        """The result on the ring's device (on a gloo ring on the card
        ``out`` is pinned, so the copy does not wait for the device),
        the host time since ``t0`` counted."""
        if self.staged:
            self.counters["staged_bytes"] += out.numel() * out.element_size()
            out = out.to(self.device, non_blocking=True)
        self.counters["seconds"] += time.perf_counter() - t0
        return out


class SubRing(Ring):
    """One rank's handle on its sub-ring of a split world
    (:meth:`Ring.split`): ``rank`` and ``size`` are its place in the
    sub-ring, ``group`` the sub-ring's process group, and its P2P peers
    map to world ranks (:meth:`peer`), so the models' collectives and
    the engine's programs run on it as on a whole ring, confined to the
    sub-ring.  Its own counters; on NCCL its communicator and the P2P
    links of its rotations are made and used once here.  ``world`` is
    the ring it was split from."""

    def __init__(self, world: Ring, ranks: Sequence[int], group):
        self.world = world
        self.ranks = [int(r) for r in ranks]
        self.group = group
        self.rank = self.ranks.index(world.rank)
        self.size = len(self.ranks)
        self.backend = world.backend
        self.device = world.device
        self._subgroups = {}
        self._gathered = {}
        self._splits = {}
        self._agreement = None
        self.counters = dict(collectives=0, hops=0, staged_bytes=0,
                             seconds=0.0)
        self.traffic = {}
        if self.nccl:
            self._warm_up(None, [list(range(self.size))])

    def peer(self, r: int) -> int:
        return self.world.peer(self.ranks[r])

    def make_groups(self, groups: Sequence[Sequence[int]]) -> None:
        raise ValueError(
            f"sub-ring groups {groups} inside a sub-ring: a process group "
            "is made by every rank of the world; split the world ring "
            "instead (Ring.split)")

    def split(self, groups):
        raise ValueError("a sub-ring does not split again; split the world "
                         "ring (Ring.split)")

    def agreement(self) -> "Agreement":
        """The world's agreement (its ranks are the world's)."""
        return self.world.agreement()


class Agreement:
    """Host decisions that every rank of a world makes alike: picklable
    objects over a gloo process group of the whole world made for them
    alone (gloo also when the model's collectives run on NCCL, so a host
    object never goes through NCCL or meets a capture).  :meth:`gather`
    gives every rank's object to every rank; :meth:`announce` rank 0's.
    ``counters``: rounds, objects received, pickled bytes received and
    host seconds inside the calls."""

    def __init__(self, world: Ring):
        import torch.distributed as dist
        self.rank, self.size = world.rank, world.size
        self.group = dist.new_group([world.peer(r) for r in range(world.size)],
                                    backend="gloo")
        self.counters = dict(rounds=0, objects=0, bytes=0, seconds=0.0)

    def gather(self, obj) -> List[Any]:
        """Every rank's ``obj``, in rank order, on every rank."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, pickle.dumps(obj), group=self.group)
        self._count(out, t0)
        return [pickle.loads(b) for b in out]

    def announce(self, obj=None):
        """Rank 0's ``obj`` on every rank (the others pass nothing)."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        box = [pickle.dumps(obj) if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        self._count(box, t0)
        return pickle.loads(box[0])

    def _count(self, got: List[bytes], t0: float) -> None:
        c = self.counters
        c["rounds"] += 1
        c["objects"] += len(got)
        c["bytes"] += sum(len(b) for b in got)
        c["seconds"] += time.perf_counter() - t0


@contextlib.contextmanager
def held_counters(ring: Optional[Ring]) -> Iterator[Dict[str, float]]:
    """A block whose collectives must not count (a warm-up, a graph
    capture): yields a dict that holds, once the block ends, what the
    block added to each counter of ``ring``; the counters are then
    restored.  Nothing without a ring."""
    made: Dict[str, float] = {}
    before = dict(ring.counters) if ring is not None else {}
    try:
        yield made
    finally:
        if ring is not None:
            for k, v in ring.counters.items():
                made[k] = v - before[k]
            ring.counters.update(before)


class Pending:
    """A collective in flight (``async_op=True``): :meth:`wait` returns
    its result on the ring's device; on gloo it blocks until the
    collective completes, on NCCL it orders the compute stream after
    NCCL's and returns at once."""

    def __init__(self, ring: Ring, works, result: torch.Tensor,
                 keep=()):
        self._ring, self._works, self._result = ring, works, result
        self._keep = keep            # send buffers the backend reads
        self._grad = None            # (input, ring, perm) under autograd

    def wait(self) -> torch.Tensor:
        if self._grad is not None:
            x, ring, perm = self._grad
            self._grad = None
            return _PPermute.apply(x, ring, perm, self)
        return self._finish()

    def _finish(self) -> torch.Tensor:
        t0 = time.perf_counter()
        for w in self._works:
            w.wait()
        self._works, self._keep = (), ()
        return self._ring._stage_out(self._result, t0)


class _Done(Pending):
    def __init__(self, value: torch.Tensor):
        self._value, self._grad = value, None

    def _finish(self) -> torch.Tensor:
        return self._value


# ---------------------------------------------------------------------------
# the axis environment
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AxisEnv:
    """The reference's ``AxisEnv`` on the port's ranks.  ``model`` is the
    rank's tensor-parallel ring (its model sub-ring on a grid), ``data``
    its data sub-ring on a ``("data", "model")`` grid (None without a
    data axis), each a :class:`Ring` whose collectives take it as their
    axis, and ``world`` the ring of every rank (the gradient norm's
    sum).  ``dp`` names the axes the batch is split over (the largest
    prefix of the plan's data axes that divides the batch), ``fsdp`` the
    axes a train plan shards its parameters over (``fsdp_width`` ranks;
    gathered by :func:`gather_param`), and ``kv_seq_axis`` the axis a
    hybrid's KV sequence is sharded over (``kv_seq_width`` ranks)."""
    model: Optional[Ring]           # the tensor-parallel ring (None: tp 1)
    tp: int
    fsdp: Tuple[str, ...] = ()      # param-gather axes (train ZeRO-3)
    dp: Tuple[str, ...] = ()        # axes the batch is actually split over
    kv_seq_axis: Optional[str] = None   # long-context KV sequence sharding
    kv_seq_width: int = 1
    data: Optional[Ring] = None     # the data sub-ring of a grid
    dwidth: int = 1                 # ranks on the data axis
    fsdp_width: int = 1             # ranks a parameter is sharded over
    world: Optional[Ring] = None    # every rank of the mesh

    @property
    def dp_width(self) -> int:
        """Ranks the batch is split over (1 without ``dp``)."""
        return self.dwidth if self.dp else 1

    @property
    def ranks(self) -> int:
        """Ranks of the mesh (1 without one)."""
        return self.world.size if self.world is not None else 1

    def axis(self, name: Optional[str]) -> Optional[Ring]:
        """The ring of the mesh axis ``name`` ("model" or "data")."""
        if name is None:
            return None
        if name == "model":
            return self.model
        if name == "data":
            return self.data
        raise ValueError(f"no mesh axis {name!r} on the port's ranks")


def grid_rings(ring: Ring, dwidth: int, tp: int
               ) -> Tuple["SubRing", "SubRing"]:
    """(model sub-ring, data sub-ring) of this rank on the grid the
    world ``ring`` forms.  Every rank calls this at the same point: the
    model sub-rings' groups are made first, then the data sub-rings',
    each on every rank in one order, and each sub-ring warms its own
    communicator (:meth:`Ring.split`).  Made once and reused."""
    from repro_torch.core.rings import Grid
    grid = Grid(dwidth, tp)
    if ring.size != grid.total:
        raise ValueError(f"a grid of data {dwidth} x model {tp} needs "
                         f"{grid.total} ranks; the ring has {ring.size}")
    return ring.split(grid.model_groups()), ring.split(grid.data_groups())


def batch_axes(plan, batch: Optional[int] = None) -> Tuple[str, ...]:
    """The data axes the batch is split over: the largest prefix of the
    plan's ``dp_axes`` whose width divides ``batch`` (all of them
    without ``batch``), the reference's rule."""
    if batch is None or plan.mesh_axes is None:
        return tuple(plan.dp_axes)
    sizes = dict(zip(plan.mesh_axes, plan.mesh_shape))
    dp: Tuple[str, ...] = ()
    width = 1
    for a in plan.dp_axes:
        if batch % (width * sizes[a]) == 0:
            dp = dp + (a,)
            width *= sizes[a]
    return dp


def make_axis_env(plan, *, batch: Optional[int] = None,
                  ring: Optional[Ring] = None) -> AxisEnv:
    """The AxisEnv of a plan: tp 1 without a mesh; on the serving ring
    (``mesh_axes=("model",)``) the rank's ``ring``, whose size must be
    the plan's tp; on a ``("data", "model")`` grid the world ``ring`` of
    ``dwidth * tp`` ranks, split into the rank's model and data
    sub-rings (:func:`grid_rings`).  ``batch`` picks the data-parallel
    axes as the reference does: the largest prefix of the plan's
    ``dp_axes`` whose width divides it (all of them without ``batch``).
    A train plan on the grid shards its parameters over ``data``
    (``fsdp``, ``fsdp_width``)."""
    if plan.mesh_axes is None:
        return AxisEnv(None, 1)
    fsdp = tuple(plan.fsdp_axes)
    if any(a != "data" for a in fsdp):
        raise NotImplementedError(f"FSDP over {fsdp}: the port shards "
                                  "parameters over 'data' only")
    if ring is None:
        raise ValueError(f"a plan for tp={plan.tp} needs the rank's ring "
                         "(see run_ranks)")
    sizes = dict(zip(plan.mesh_axes, plan.mesh_shape))
    world = 1
    for s in plan.mesh_shape:
        world *= s
    if ring.size != world:
        raise ValueError(f"plan built for {plan.mesh_axes}{plan.mesh_shape} "
                         f"({world} ranks), ring of {ring.size} ranks")
    dp = batch_axes(plan, batch)
    kv_axis, kv_w = None, 1
    if getattr(plan, "kv_seq_axis", None):
        kv_axis = plan.kv_seq_axis
        kv_w = sizes[kv_axis]
    if "data" not in sizes:
        return AxisEnv(ring, plan.tp, dp=dp, kv_seq_axis=kv_axis,
                       kv_seq_width=kv_w, world=ring)
    model, data = grid_rings(ring, sizes["data"], plan.tp)
    return AxisEnv(model, plan.tp, fsdp=fsdp, dp=dp, kv_seq_axis=kv_axis,
                   kv_seq_width=kv_w, data=data, dwidth=sizes["data"],
                   fsdp_width=sizes["data"] if fsdp else 1, world=ring)


# ---------------------------------------------------------------------------
# FSDP (ZeRO-3) parameter gathering, the data axes' sums
# ---------------------------------------------------------------------------

def fsdp_dim(shape: Sequence[int], width: int,
             skip_dims: Sequence[int] = ()) -> Optional[int]:
    """First dim divisible by the FSDP width (the mapper's ZeRO rule)."""
    if width <= 1:
        return None
    for i, s in enumerate(shape):
        if i in skip_dims:
            continue
        if s % width == 0 and s >= width:
            return i
    return None


def gather_param(w: torch.Tensor, env: AxisEnv,
                 dim: Optional[int]) -> torch.Tensor:
    """All-gather one FSDP-sharded parameter along ``dim`` over the data
    ring; under autograd its gradient is reduce-scattered back to the
    shard (ZeRO gradient sharding)."""
    if dim is None or not env.fsdp or env.fsdp_width <= 1:
        return w
    return all_gather(w, env.data, dim=dim)


def gather_tree(tree, env: AxisEnv, dims_tree):
    """Gather a whole (sub)tree of parameters given its fsdp-dims tree."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, env, dims_tree[k]) for k, v in tree.items()}
    return gather_param(tree, env, dims_tree)


def psum_dp(x: torch.Tensor, env: AxisEnv) -> torch.Tensor:
    """The sum over the axes the batch is split over."""
    return psum(x, env.data) if env.dp else x


def pmean_dp(x: torch.Tensor, env: AxisEnv) -> torch.Tensor:
    """The mean over the axes the batch is split over."""
    return pmean(x, env.data) if env.dp else x


def model_rank(env: Optional[AxisEnv]) -> int:
    """This rank's index on the model ring (0 without one)."""
    if env is None or env.model is None:
        return 0
    return env.model.rank


def on_ring(env: Optional[AxisEnv]) -> bool:
    """True when ``env`` spans a ring of more than one rank."""
    return env is not None and env.model is not None and env.tp > 1


def ring_axis(env: Optional[AxisEnv]) -> Tuple[Optional[Ring], int]:
    """(the model ring, its size) of ``env``, or (None, 1) off the ring:
    the ``axis``/``tp`` the ESL matmuls and collectives take."""
    return (env.model, env.tp) if on_ring(env) else (None, 1)


# ---------------------------------------------------------------------------
# collectives (reference names and semantics)
# ---------------------------------------------------------------------------

def axis_index(axis: Optional[Ring]) -> int:
    """This rank's index on ``axis`` (0 without a ring)."""
    return 0 if axis is None else axis.rank


def _grad_path(x: torch.Tensor) -> bool:
    """Whether a collective of ``x`` runs under autograd."""
    return torch.is_grad_enabled() and x.requires_grad


def ppermute(x: torch.Tensor, axis: Optional[Ring],
             perm: Sequence[Tuple[int, int]], async_op: bool = False):
    """Send ``x`` along the (source, destination) pairs of ``perm``
    (ring ranks) and return what this rank received: zeros when no pair
    ends here, as ``lax.ppermute``.  ``async_op=True`` returns a
    :class:`Pending` whose ``wait()`` gives the received tensor, so the
    caller can launch work in between (the ESL overlap); under autograd
    the received tensor's gradient goes back along the inverse pairs."""
    if axis is None:
        return _Done(x) if async_op else x
    if _grad_path(x):
        if not async_op:
            return _PPermute.apply(x, axis, perm, None)
        pending = _ppermute(x, axis, perm, True)
        pending._grad = (x, axis, perm)
        return pending
    return _ppermute(x, axis, perm, async_op)


def _ppermute(x: torch.Tensor, axis: Ring,
              perm: Sequence[Tuple[int, int]], async_op: bool):
    import torch.distributed as dist
    t0 = time.perf_counter()
    me = axis.rank
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm} sends or receives twice at rank {me}")
    axis.counters["collectives"] += 1
    axis.counters["hops"] += 1
    axis._traffic("ppermute", _nbytes(x) if src and src != [me] else 0)
    if dst == [me] and src == [me]:
        out = x.clone()
        return _Done(out) if async_op else out
    send = axis._stage_in(x) if dst else None
    recv = axis._buffer(x.shape, x.dtype)
    if axis.nccl:
        # one batch on the ring's communicator: no pair communicator,
        # and the send and the receive start together
        ops = ([dist.P2POp(dist.isend, send, axis.peer(dst[0]),
                           group=axis.group)] if dst else [])
        if src:
            ops.append(dist.P2POp(dist.irecv, recv, axis.peer(src[0]),
                                  group=axis.group))
        works = dist.batch_isend_irecv(ops) if ops else []
    else:
        works = []
        if send is not None:
            works.append(dist.isend(send, axis.peer(dst[0]),
                                    group=axis.group))
        if src:
            works.append(dist.irecv(recv, axis.peer(src[0]),
                                    group=axis.group))
    if not src:
        recv.zero_()
    pending = Pending(axis, works, recv, keep=(send,))
    axis.counters["seconds"] += time.perf_counter() - t0
    return pending if async_op else pending._finish()


def _swap(axis: Ring, groups: Groups, outgoing: List[torch.Tensor]
          ) -> List[torch.Tensor]:
    """One round of the group on gloo: ``outgoing[j]`` goes to the
    group's j-th rank, and one tensor of the same shape comes back from
    each peer.  Returns the parts in group order, this rank's own
    ``outgoing`` entry at its place."""
    import torch.distributed as dist
    pg, ranks = axis._group(groups)
    me = ranks.index(axis.rank)
    axis.counters["collectives"] += 1
    parts: List[torch.Tensor] = list(outgoing)
    works = []
    for j, peer in enumerate(ranks):
        if j != me:
            parts[j] = axis._buffer(outgoing[me].shape, outgoing[me].dtype)
            works.append(dist.irecv(parts[j], axis.peer(peer), group=pg))
    for j, peer in enumerate(ranks):
        if j != me:
            works.append(dist.isend(outgoing[j], axis.peer(peer), group=pg))
    for w in works:
        w.wait()
    return parts


def _parts(axis: Ring, groups: Groups, x: torch.Tensor
           ) -> List[torch.Tensor]:
    """Every group rank's ``x`` (already staged), in group order, from
    one collective: an all-gather on NCCL, a round of swaps on gloo."""
    if not axis.nccl:
        return _swap(axis, groups, [x] * len(axis._group(groups)[1]))
    import torch.distributed as dist
    pg, ranks = axis._group(groups)
    axis.counters["collectives"] += 1
    out = axis._buffer((len(ranks) * x.numel(),), x.dtype)
    dist.all_gather_into_tensor(out, x.reshape(-1), group=pg)
    return list(out.view((len(ranks),) + tuple(x.shape)).unbind(0))


def all_gather(x: torch.Tensor, axis: Optional[Ring], dim: int = -1,
               groups: Groups = None) -> torch.Tensor:
    """Every rank's ``x`` in rank order, concatenated along ``dim`` (the
    reference's tiled form)."""
    if axis is None:
        return x
    if _grad_path(x):
        return _AllGather.apply(x, axis, dim, groups)
    return _all_gather(x, axis, dim, groups)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _peers(axis: Ring, groups: Groups) -> int:
    """The other ranks of this rank's group."""
    return len(axis._group(groups)[1]) - 1


def _all_gather(x: torch.Tensor, axis: Ring, dim: int,
                groups: Groups) -> torch.Tensor:
    axis._traffic("all_gather", _peers(axis, groups) * _nbytes(x))
    t0 = time.perf_counter()
    parts = _parts(axis, groups, axis._stage_in(x))
    shape = list(parts[0].shape)
    shape[dim] *= len(parts)
    out = axis._buffer(shape, parts[0].dtype)
    torch.cat(parts, dim, out=out)
    return axis._stage_out(out, t0)


def all_gather_param(v: torch.Tensor, axis: Optional[Ring],
                     dim: int = -1) -> torch.Tensor:
    """``all_gather(v)`` of a parameter, made once and kept on the ring
    while the parameter's storage lives unmodified: a parameter's shards
    do not change between steps, so the blocking baseline gathers each
    norm vector and position table once, not every step.  Keyed by the
    storage the view reads (a stacked layer's slice is a new view each
    step), checked against the tensor that owns it and its version."""
    if axis is None:
        return v
    if _grad_path(v):
        return all_gather(v, axis, dim=dim)     # a training step's leaf
    owner = v._base if v._base is not None else v
    key = (v.data_ptr(), tuple(v.shape), tuple(v.stride()), v.dtype, dim)
    hit = axis._gathered.get(key)
    if hit is not None and hit[0]() is owner and hit[1] == v._version:
        return hit[2]
    full = all_gather(v, axis, dim=dim)
    axis._gathered[key] = (weakref.ref(owner), v._version, full)
    return full


def _fold(axis: Ring, parts: List[torch.Tensor], op) -> torch.Tensor:
    """``op`` folded over ``parts`` in rank order, into a new buffer."""
    out = axis._buffer(parts[0].shape, parts[0].dtype)
    if len(parts) == 1:
        return out.copy_(parts[0])
    op(parts[0], parts[1], out=out)
    for p in parts[2:]:
        op(out, p, out=out)
    return out


def _reduce(x: torch.Tensor, axis: Ring, op, groups: Groups
            ) -> Tuple[torch.Tensor, int, float]:
    t0 = time.perf_counter()
    parts = _parts(axis, groups, axis._stage_in(x))
    return _fold(axis, parts, op), len(parts), t0


def psum(x: torch.Tensor, axis: Optional[Ring],
         groups: Groups = None) -> torch.Tensor:
    """The sum of ``x`` over the ring (or this rank's sub-ring)."""
    if axis is None:
        return x
    if _grad_path(x):
        return _Psum.apply(x, axis, groups)
    return _psum(x, axis, groups)


def _psum(x: torch.Tensor, axis: Ring, groups: Groups) -> torch.Tensor:
    axis._traffic("psum", _peers(axis, groups) * _nbytes(x))
    out, _, t0 = _reduce(x, axis, torch.add, groups)
    return axis._stage_out(out, t0)


def pmax(x: torch.Tensor, axis: Optional[Ring],
         groups: Groups = None) -> torch.Tensor:
    """The elementwise max of ``x`` over the ring, outside autograd (a
    stop-gradient shift, as the reference uses it)."""
    if axis is None:
        return x
    axis._traffic("pmax", _peers(axis, groups) * _nbytes(x))
    out, _, t0 = _reduce(x.detach(), axis, torch.maximum, groups)
    return axis._stage_out(out, t0)


def pmean(x: torch.Tensor, axis: Optional[Ring],
          groups: Groups = None) -> torch.Tensor:
    """The mean of ``x`` over the ring: the sum divided by its size."""
    if axis is None:
        return x
    if _grad_path(x):
        return _Pmean.apply(x, axis, groups)
    return _pmean(x, axis, groups)


def _pmean(x: torch.Tensor, axis: Ring, groups: Groups) -> torch.Tensor:
    axis._traffic("pmean", _peers(axis, groups) * _nbytes(x))
    out, n, t0 = _reduce(x, axis, torch.add, groups)
    return axis._stage_out(out, t0) / n


def psum_scatter(x: torch.Tensor, axis: Optional[Ring], dim: int = -1,
                 groups: Groups = None) -> torch.Tensor:
    """This rank's block of the ring sum of ``x``, split along ``dim``
    (the reference's tiled form: ``dim`` shrinks by the ring's size):
    on gloo each rank sends block j to the group's j-th rank; on NCCL
    the whole tensors are gathered.  Each rank sums the blocks that are
    its own, in rank order."""
    if axis is None:
        return x
    if _grad_path(x):
        return _PsumScatter.apply(x, axis, dim, groups)
    return _psum_scatter(x, axis, dim, groups)


def _psum_scatter(x: torch.Tensor, axis: Ring, dim: int,
                  groups: Groups) -> torch.Tensor:
    n = _peers(axis, groups) + 1
    # NCCL gathers the whole tensors, gloo sends each rank its block
    axis._traffic("psum_scatter", (n - 1) * _nbytes(x) // (1 if axis.nccl
                                                          else n))
    t0 = time.perf_counter()
    staged = axis._stage_in(x)
    _, ranks = axis._group(groups)
    n, me = len(ranks), ranks.index(axis.rank)
    if axis.nccl:
        parts = [p.chunk(n, dim)[me] for p in _parts(axis, groups, staged)]
    else:
        parts = _swap(axis, groups,
                      [b.contiguous() for b in staged.chunk(n, dim)])
    return axis._stage_out(_fold(axis, parts, torch.add), t0)


def all_to_all(x: torch.Tensor, axis: Optional[Ring],
               groups: Groups = None) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=False)``: ``x`` (n, ...) on
    a ring of n ranks; block j goes to rank j, and block j of the result
    is what rank j sent here.  On NCCL one ``all_to_all_single`` of the
    device tensors; on gloo one round of swaps (staged through the host
    on a card)."""
    if axis is None:
        return x
    if _grad_path(x):
        return _AllToAll.apply(x, axis, groups)
    return _all_to_all(x, axis, groups)


def _all_to_all(x: torch.Tensor, axis: Ring, groups: Groups) -> torch.Tensor:
    n = _peers(axis, groups) + 1
    axis._traffic("all_to_all", (n - 1) * _nbytes(x) // n)
    t0 = time.perf_counter()
    pg, ranks = axis._group(groups)
    if x.shape[0] != len(ranks):
        raise ValueError(f"all_to_all of {tuple(x.shape)} on {len(ranks)} "
                         "ranks: dim 0 must be the ranks")
    staged = axis._stage_in(x)
    out = axis._buffer(staged.shape, staged.dtype)
    if axis.nccl:
        import torch.distributed as dist
        axis.counters["collectives"] += 1
        dist.all_to_all_single(out, staged, group=pg)
    else:
        torch.stack(_swap(axis, groups, list(staged.unbind(0))), out=out)
    return axis._stage_out(out, t0)


# ---------------------------------------------------------------------------
# the collectives under autograd: each backward is the forward's adjoint,
# run with the plain collectives (no double backward)
# ---------------------------------------------------------------------------

class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm, pending):
        ctx.axis, ctx.perm = axis, list(perm)
        if pending is not None:
            return pending._finish()
        return _ppermute(x, axis, perm, False)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.perm]
        return _ppermute(g, ctx.axis, back, False), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, groups):
        ctx.axis, ctx.dim, ctx.groups = axis, dim, groups
        return _all_gather(x, axis, dim, groups)

    @staticmethod
    def backward(ctx, g):
        return (_psum_scatter(g, ctx.axis, ctx.dim, ctx.groups), None, None,
                None)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, groups):
        ctx.axis, ctx.dim, ctx.groups = axis, dim, groups
        return _psum_scatter(x, axis, dim, groups)

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g, ctx.axis, ctx.dim, ctx.groups), None, None,
                None)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, groups):
        ctx.axis, ctx.groups = axis, groups
        return _psum(x, axis, groups)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.axis, ctx.groups), None, None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, groups):
        ctx.axis, ctx.groups = axis, groups
        return _pmean(x, axis, groups)

    @staticmethod
    def backward(ctx, g):
        return _pmean(g, ctx.axis, ctx.groups), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, groups):
        ctx.axis, ctx.groups = axis, groups
        return _all_to_all(x, axis, groups)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.axis, ctx.groups), None, None


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

PLACEMENTS = ("card_per_rank", "shared_card")


def rank_devices(tp: int, device=None,
                 placement: Optional[str] = None) -> List[torch.device]:
    """The device of each of ``tp`` ranks (every rank of the world: a
    grid's ``dwidth * tp``, rank l on ``cuda:l``).  On the CPU every
    rank runs there (``placement`` None).  On CUDA the caller chooses,
    and nothing chooses for it: ``"card_per_rank"`` puts rank r on
    ``cuda:r`` and raises when the machine has fewer than ``tp`` cards;
    ``"shared_card"`` puts every rank on the one card."""
    from repro_torch.device import resolve_device
    if tp < 1:
        raise ValueError(f"tp={tp} must be >= 1")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and placement == "card_per_rank":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < tp:
            raise RuntimeError(
                f"tp={tp} with a card per rank needs {tp} cards; this "
                f"machine has {have} (every rank on one card over gloo: "
                "placement 'shared_card', --shared-card)")
    dev = resolve_device(dev)
    if dev.type == "cpu":
        if placement is not None:
            raise ValueError(f"placement={placement!r} places ranks on "
                             "cards; ranks on the CPU take none")
        return [dev] * tp
    if placement == "card_per_rank":
        return [torch.device("cuda", r) for r in range(tp)]
    if placement == "shared_card":
        return [torch.device("cuda", dev.index or 0)] * tp
    raise ValueError(
        f"ranks on {dev} need placement='card_per_rank' (NCCL, rank r on "
        "cuda:r) or 'shared_card' (gloo, every rank on one card); got "
        f"{placement!r}")


def backend_for(devices: Sequence) -> str:
    """The ring's backend for ranks on ``devices``: NCCL when each rank
    has a CUDA device of its own, gloo when they all run on the CPU or
    share one device.  Any other mix raises."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cpu" for d in devs) or len(set(devs)) == 1:
        return "gloo"
    if all(d.type == "cuda" and d.index is not None for d in devs) and \
            len(set(devs)) == len(devs):
        return "nccl"
    raise ValueError(
        f"ranks on {[str(d) for d in devs]}: a ring runs on the CPU, on "
        "one shared card (gloo) or on a card per rank (NCCL)")


def _rank_main(rank: int, fn: Callable, devices: Sequence[str],
               backend: str, tmp: str, threads: Optional[int],
               timeout_s: float, args: tuple) -> None:
    """One spawned rank: join the ring through the FileStore on
    ``devices[rank]``, run ``fn(ring, *args)``, and (rank 0) write its
    result.  On NCCL the default group's communicator is made at once
    (``device_id``), over the loopback interface unless the environment
    names another: every rank is on this host."""
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(int(threads))
    dev = torch.device(devices[rank])
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "nccl":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        kw["device_id"] = dev
    tp = len(devices)
    store = dist.FileStore(os.path.join(tmp, "store"), tp)
    dist.init_process_group(backend, store=store, rank=rank, world_size=tp,
                            timeout=timedelta(seconds=timeout_s), **kw)
    try:
        out = fn(Ring(dev), *args)
        if rank == 0:
            part = os.path.join(tmp, "result.part")
            with open(part, "wb") as f:
                pickle.dump(out, f)
            os.replace(part, os.path.join(tmp, "result.pkl"))
        dist.barrier()
    except BaseException:
        if backend == "nccl":
            # the failed rank's frames still hold its NCCL state (an
            # engine's captured graphs, a peer's pending collective), and
            # destroying the group then waits forever: report and leave
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, tp: int, *args, device=None,
              placement: Optional[str] = None,
              threads: Optional[int] = None,
              timeout_s: float = 900.0) -> Any:
    """Run ``fn(ring, *args)`` in ``tp`` spawned processes, one per rank
    of a ring on ``device`` (``cuda`` unless the caller asks for the
    CPU), placed as ``placement`` says (:func:`rank_devices`: a card per
    rank over NCCL, or the shared card over gloo; required on CUDA), and
    return rank 0's result (it must pickle).  ``fn`` must be a
    module-level function the children can import.  ``threads`` sets
    torch's thread count in every rank.  A rank that raises or dies
    fails the run: the others are terminated and the error is raised
    here.  ``timeout_s`` bounds a collective that waits for a rank that
    never comes."""
    import torch.multiprocessing as mp
    devices = rank_devices(tp, device, placement)
    backend = backend_for(devices)
    with tempfile.TemporaryDirectory(prefix="ring-") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, [str(d) for d in devices], backend, tmp,
                              threads, timeout_s, tuple(args)),
            nprocs=tp, join=False, start_method="spawn")
        while not ctx.join():
            pass
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
