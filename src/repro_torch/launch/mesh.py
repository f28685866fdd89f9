"""Meshes of rank processes, and a launcher that starts them.

Port of ``repro/launch/mesh.py``.  The reference builds a JAX device
mesh; here a mesh is a grid laid over the ranks of a running
``torch.distributed`` process group, with one process group per axis
(and one over the batch axes together) over the ranks that share every
other coordinate.
Ranks are laid out row-major: rank = Σ coord[i] · Π shape[i+1:].  The
TPU constants of the reference module (peak rates, link bandwidths) are
not carried: the port's numbers come from the card.

``run_ranks`` starts W rank processes (``torch.multiprocessing`` spawn),
joins them to one process group through a ``file://`` rendezvous in a
fresh temporary directory (so parallel callers never meet), waits at a
barrier until every rank has joined, runs ``fn(rank, world, *args)`` in
each and returns each rank's result.  A rank's exception reaches the
caller, which then raises; so does a run that outlives ``timeout``.  The
barrier keeps a rank with nothing to exchange from finishing and tearing
its group down while a peer is still connecting, which would make the
peer's connection error the first failure the caller sees.

``use_mesh(mesh)`` installs a mesh for the code run within it and
``current_mesh()`` returns the innermost one (None outside): the
reference's ambient JAX mesh (``compat.set_mesh`` /
``get_abstract_mesh``), which ``models/layers.py::moe`` reads to choose
its expert-parallel branch.

The backend is explicit: ``nccl`` for CUDA ranks by default, ``gloo`` for
host ones.  NCCL takes one card a rank, so W ranks sharing fewer cards
raise here, before NCCL's own error: such ranks run over ``gloo``
(``core/comm.py::ShardComm`` then stages CUDA tensors through host
memory).
"""

from __future__ import annotations

import itertools
import os
import shutil
import tempfile
import time
from contextlib import contextmanager
from datetime import timedelta

import torch

from repro_torch.core.comm import ShardComm

BATCH_AXES = ("pod", "data")  # the axes a batch is split over


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, world: int, device) -> None:
    """Raise for a backend the ranks cannot use: ``nccl`` on host ranks,
    or more ``nccl`` ranks than cards."""
    dev = torch.device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend takes CUDA ranks; use gloo "
                             "for device='cpu'")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"nccl takes one card a rank: {world} ranks on {cards} "
                f"card(s) would share a card, which NCCL refuses; run them "
                "over backend='gloo'")


class Mesh:
    """Named axes over ranks of the default process group (all of them,
    or those ``make_mesh`` was given; ``rank`` is this rank's place among
    them).  ``group(axes)`` is this rank's process group over one axis or
    a set of them and ``comm(axes)`` a ``ShardComm`` over it."""

    def __init__(self, shape, axes, groups, rank):
        self.shape = tuple(shape)
        self.axes = tuple(axes)
        self._groups = groups
        self._comms = {}
        self.rank = rank
        idx, coords = rank, []
        for s in reversed(self.shape):
            coords.append(idx % s)
            idx //= s
        self.coords = dict(zip(self.axes, reversed(coords)))

    def _key(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axes:
                raise KeyError(f"mesh has no axis {a!r} (axes {self.axes})")
        return tuple(a for a in self.axes if a in axes)

    def group(self, axes):
        key = self._key(axes)
        if key not in self._groups:
            raise KeyError(f"mesh has no group over {key}: make_mesh builds "
                           f"one a single axis and one over {BATCH_AXES}")
        return self._groups[key]

    def comm(self, axes) -> ShardComm:
        """A new ``ShardComm`` over ``group(axes)``: its counters start at
        0 (each sharded step reads its own)."""
        return ShardComm(self.group(axes))

    def shared_comm(self, axes) -> ShardComm:
        """ONE ``ShardComm`` over ``group(axes)`` for the mesh's lifetime:
        the model code's collectives (the tensor-parallel combine, the
        expert-parallel all-to-alls) all count in its ``stats``/``ops``."""
        key = self._key(axes)
        if key not in self._comms:
            self._comms[key] = self.comm(key)
        return self._comms[key]

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axes, self.shape))


def make_mesh(shape, axes, backend=None, device="cuda", ranks=None):
    """A mesh of ``shape`` over named ``axes`` laid over ``ranks`` of the
    running default process group (all of them by default; their count
    must be ``prod(shape)``).  Builds one group per axis and one over the
    batch axes together (``BATCH_AXES``, where the mesh has more than one
    of them: the data-parallel group of the sharded step); every rank of
    the process group must call it, member or not (group creation is
    collective), and a rank outside ``ranks`` gets None.  ``backend``
    defaults to the default group's."""
    import torch.distributed as dist

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a running process group "
                           "(torch.distributed.init_process_group)")
    whole = ranks is None
    ranks = list(range(dist.get_world_size())) if whole else list(ranks)
    if len(ranks) != n:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks, "
                         f"it is given {len(ranks)}")
    backend = backend or str(dist.get_backend())
    check_backend(backend, n, device)
    coords = list(itertools.product(*(range(s) for s in shape)))
    subsets = [(i,) for i in range(len(axes))]
    batch = tuple(i for i, a in enumerate(axes) if a in BATCH_AXES)
    if len(batch) > 1:
        subsets.append(batch)
    groups = {}
    for sub in subsets:
        key = tuple(axes[i] for i in sub)
        if len(sub) == len(axes) and whole:
            groups[key] = None  # the default group: every rank
            continue
        by_rest = {}
        for r, c in zip(ranks, coords):
            rest = tuple(c[i] for i in range(len(axes)) if i not in sub)
            by_rest.setdefault(rest, []).append(r)
        groups[key], _ = dist.new_subgroups_by_enumeration(
            list(by_rest.values()), backend=backend)
    me = dist.get_rank()
    if me not in ranks:
        return None
    return Mesh(shape, axes, groups, ranks.index(me))


def production_mesh_shape(*, multi_pod: bool = False, tp_degree: int = 16):
    """(shape, axes) of the reference's 256-rank mesh (512 with
    ``multi_pod``): the trailing "model" axis carries ``tp_degree`` ranks
    and the "data" axis the rest."""
    if tp_degree < 1 or 256 % tp_degree:
        raise ValueError(f"tp_degree must divide 256, got {tp_degree}")
    dp = 256 // tp_degree
    if multi_pod:
        return (2, dp, tp_degree), ("pod", "data", "model")
    return (dp, tp_degree), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, tp_degree: int = 16,
                         backend=None, device="cuda") -> Mesh:
    """The reference's production mesh over a running process group of
    256 (or 512) ranks."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod,
                                        tp_degree=tp_degree)
    return make_mesh(shape, axes, backend=backend, device=device)


_MESHES: list = []


@contextmanager
def use_mesh(mesh):
    """Install ``mesh`` (a ``Mesh``) as the current mesh for the code run
    within, as the reference's ``set_mesh``."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The innermost mesh of ``use_mesh``, or None."""
    return _MESHES[-1] if _MESHES else None


# ---------------------------------------------------------------------------
# starting rank processes
# ---------------------------------------------------------------------------
def _rank_main(rank, fn, world, args, backend, device, init, out_dir,
               collective_s):
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=timedelta(seconds=collective_s))
    try:
        # every rank joins before any runs fn: a rank that finished early
        # would tear the group down under a peer still connecting
        if backend == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
        out = fn(rank, world, *args)
        path = os.path.join(out_dir, f"rank{rank}.pt")
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args=(), *, backend=None, device="cuda",
              timeout: float = 600.0, collective_timeout: float = 300.0):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    to one process group; returns the list of their results (loaded on
    the host).  ``fn`` must be importable by name (a module-level
    function) and its result picklable by ``torch.save``.  Raises when a
    rank raises or dies, or when the run outlives ``timeout`` seconds;
    every rank process is stopped before it returns or raises.  Each
    rank's collectives time out after ``collective_timeout`` seconds."""
    import torch.multiprocessing as mp

    backend = backend or default_backend(device)
    check_backend(backend, world, device)
    out_dir = tempfile.mkdtemp(prefix="ranks-")
    init = "file://" + os.path.join(out_dir, "rendezvous")
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, tuple(args), backend, str(device),
                          init, out_dir, collective_timeout),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout:.0f} s")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(out_dir, ignore_errors=True)
