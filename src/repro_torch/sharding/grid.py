"""A grid of ranks over ``torch.distributed``: the port's device mesh.

The reference runs its multi-device profile (backend ``lace_dp``) as one
SPMD program over a ``jax`` mesh with the axes ``("data", "model")`` or
``("pod", "data", "model")``: the stacked client axis is split over the
client axes ``pod`` and ``data``, each client's batch over ``model``
(``sharding/logical.py:RULES_DP``), and the weights are replicated. The
port runs the same program once per process: a :class:`Grid` names the
axes and their sizes, places this rank on them as ``jax.make_mesh``
places devices (row-major, the last axis fastest), and holds the three
process groups the program's collectives run over:

* ``client`` -- the ranks that share this rank's ``model`` coordinate:
  one rank per client shard (the reference's psum over ``("pod",
  "data")``);
* ``inner`` -- the ranks that share this rank's client shard: one per
  ``model`` coordinate (the psum over ``"model"``);
* ``all`` -- every rank.

A grid of one rank is the single-program case; its collectives still go
through the (one-rank) groups.

Collectives. :meth:`Grid.all_reduce` sums a tensor in place over a
group, :meth:`Grid.all_reduce_tree` a whole tree in one call (its leaves
packed into one flat buffer, optionally in a narrower dtype on the wire),
:meth:`Grid.all_gather_host` gathers a host (numpy) array. NCCL takes
CUDA tensors only, so a host array goes to the card for its gather and
back; gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` but
not for ``all_gather``, so :meth:`Grid.all_gather` moves a CUDA tensor
through host memory under gloo, and only there. A collective that fails
raises; nothing falls back to another backend or device.
``Grid.stats`` counts each group's calls and bytes.

Layout. A spec is a tuple with one entry per dimension: ``None``
(replicated), an axis name, or a tuple of axis names (split over their
product, row-major), as a ``PartitionSpec``. :func:`spec_for` resolves
logical axis names against a grid with the reference's ``RULES_DP``
(the divisibility fallback included), :meth:`Grid.shard` cuts this
rank's block of a global array, :meth:`Grid.local_clients` /
:meth:`Grid.gather_clients` cut and reassemble the stacked client axis.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import leaves, tree_map, unflatten

#: the mesh axes that carry clients, in the reference's order
CLIENT_AXES = ("pod", "data")
#: the axis a client's batch splits over
INNER_AXES = ("model",)
#: the reference's two mesh layouts
LAYOUTS = (("data", "model"), ("pod", "data", "model"))
GROUPS = ("client", "inner", "all")

#: ``RULES_DP`` of the reference's ``sharding/logical.py`` for the
#: logical axes of a training batch and a client scalar: client-parallel
#: over the client axes, each client's rows over ``model``; every other
#: name is replicated.
RULES_DP: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    "client": (("pod", "data"), ("data",)),
    "batch": (("pod", "data", "model"), ("data", "model"), ("pod", "data"),
              ("data",)),
    "per_client_batch": (("model",),),
}


class Grid:
    """This rank's place on a grid of ``shape`` over ``axis_names``.

    The default process group must be initialized with ``prod(shape)``
    ranks; every rank constructs its grid with the same arguments at the
    same point (the groups are created collectively).
    """

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int]):
        axis_names, shape = tuple(axis_names), tuple(int(s) for s in shape)
        if axis_names not in LAYOUTS:
            raise ValueError(f"grid axes {axis_names} are not one of the "
                             f"reference's layouts {LAYOUTS}")
        if len(shape) != len(axis_names) or min(shape) < 1:
            raise ValueError(f"grid shape {shape} does not fit the axes "
                             f"{axis_names}")
        if not dist.is_initialized():
            raise RuntimeError("a Grid needs an initialized default process "
                               "group (torch.distributed.init_process_group)")
        world = dist.get_world_size()
        if int(np.prod(shape)) != world:
            raise ValueError(f"grid {dict(zip(axis_names, shape))} has "
                             f"{int(np.prod(shape))} ranks; the process "
                             f"group has {world}")
        self._place(axis_names, shape, dist.get_rank())
        self.backend = dist.get_backend()
        # every rank creates every group, in one order
        ranks = np.arange(self.world).reshape(shape)
        n_inner = self.inner_size
        by_client = ranks.reshape(self.n_client_shards, n_inner)
        self.groups = {"all": dist.group.WORLD}
        for m in range(n_inner):
            g = dist.new_group([int(r) for r in by_client[:, m]])
            if m == self.inner_index:
                self.groups["client"] = g
        for c in range(self.n_client_shards):
            g = dist.new_group([int(r) for r in by_client[c]])
            if c == self.client_index:
                self.groups["inner"] = g

    def _place(self, axis_names, shape, rank: int) -> None:
        """This rank's coordinates, its client shard and its inner index
        on ``shape`` over ``axis_names`` (row-major, the last axis
        fastest), and zeroed stats."""
        self.world = int(np.prod(shape))
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.rank = rank
        self.coords = dict(zip(axis_names,
                               (int(c) for c in np.unravel_index(rank,
                                                                 shape))))
        self.client_axes = tuple(a for a in CLIENT_AXES if a in axis_names)
        self.inner_axes = tuple(a for a in INNER_AXES if a in axis_names)
        self.n_client_shards = int(np.prod(
            [self.shape[a] for a in self.client_axes]))
        self.client_index = self.index_on(self.client_axes)
        self.inner_size = int(np.prod([self.shape[a]
                                       for a in self.inner_axes]))
        self.inner_index = self.index_on(self.inner_axes)
        self.sizes = {"client": self.n_client_shards,
                      "inner": self.inner_size, "all": self.world}
        self.stats = {g: {"calls": 0, "bytes": 0} for g in GROUPS}

    def __repr__(self):
        return (f"Grid({self.shape}, rank={self.rank}, backend="
                f"{self.backend!r})")

    # ------------------------------------------------------------------
    # coordinates
    # ------------------------------------------------------------------

    def index_on(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (0 for none)."""
        ix = 0
        for a in axes:
            ix = ix * self.shape[a] + self.coords[a]
        return ix

    @property
    def host_device(self) -> torch.device:
        """Where a host array goes for a collective: the CPU under gloo,
        this rank's card under NCCL."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    # ------------------------------------------------------------------
    # layout
    # ------------------------------------------------------------------

    def _blocks(self, entry):
        """(number of blocks, this rank's block) of one spec entry."""
        if entry is None:
            return 1, 0
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        n = int(np.prod([self.shape[a] for a in names]))
        return n, self.index_on(names)

    def shard(self, a, spec):
        """This rank's block of the global array ``a`` (tensor or numpy)
        under ``spec`` (entries past ``spec``'s length are replicated)."""
        for dim, entry in enumerate(spec):
            n, i = self._blocks(entry)
            if n == 1:
                continue
            size = a.shape[dim]
            if size % n:
                raise ValueError(f"dimension {dim} of size {size} does not "
                                 f"divide over {entry!r} ({n} ranks)")
            step = size // n
            a = a[(slice(None),) * dim + (slice(i * step, (i + 1) * step),)]
        return a

    def client_slice(self, n: int) -> slice:
        """This rank's rows of a leading client axis of ``n`` slots."""
        if n % self.n_client_shards:
            raise ValueError(f"{n} client slots must divide over the "
                             f"{self.n_client_shards} client shards")
        k = n // self.n_client_shards
        return slice(self.client_index * k, (self.client_index + 1) * k)

    def local_clients(self, tree):
        """Every leaf's rows of this rank's client shard (leading axis);
        a numpy leaf stays numpy."""
        return tree_map(lambda a: a[self.client_slice(a.shape[0])], tree)

    def gather_clients(self, tree):
        """The inverse of :meth:`local_clients`: each leaf's client shards
        gathered in shard order (one all_gather a leaf)."""
        return tree_map(lambda a: self.all_gather(a, "client"), tree)

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------

    def _count(self, group: str, t: torch.Tensor):
        self.stats[group]["calls"] += 1
        self.stats[group]["bytes"] += t.numel() * t.element_size()

    def reset_stats(self):
        for s in self.stats.values():
            s["calls"] = s["bytes"] = 0

    def _check_device(self, t: torch.Tensor, what: str):
        if self.backend == "nccl" and t.device.type != "cuda":
            raise ValueError(f"{what} over NCCL takes CUDA tensors, got "
                             f"{t.device}")

    def all_reduce(self, t: torch.Tensor, group: str = "all",
                   op: str = "sum") -> torch.Tensor:
        """``t`` summed (or maxed) over ``group``, in place; returns it."""
        self._check_device(t, "all_reduce")
        self._count(group, t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self.groups[group])
        return t

    def all_reduce_tree(self, tree, group: str = "all",
                        wire_dtype: Optional[torch.dtype] = None):
        """Every leaf of ``tree`` summed over ``group`` in ONE collective:
        the leaves packed into one flat buffer (in ``wire_dtype`` when
        given, else their common dtype), reduced, and unpacked into a new
        tree, each leaf back in its own dtype."""
        flat = leaves(tree)
        if not flat:
            return tree
        dtype = wire_dtype or flat[0].dtype
        if wire_dtype is None and any(a.dtype != dtype for a in flat):
            dtype = torch.float32
        buf = torch.cat([a.reshape(-1).to(dtype) for a in flat])
        self.all_reduce(buf, group)
        out, start = [], 0
        for a in flat:
            n = a.numel()
            out.append(buf[start:start + n].view(a.shape).to(a.dtype))
            start += n
        return unflatten(tree, out)

    def all_gather(self, t: torch.Tensor, group: str = "client"):
        """``t`` from every rank of ``group`` concatenated on dim 0, in
        group order. Under gloo a CUDA tensor makes the trip through host
        memory (gloo has no CUDA all_gather)."""
        self._check_device(t, "all_gather")
        via_host = self.backend == "gloo" and t.device.type == "cuda"
        src = (t.detach().cpu() if via_host else t.detach()).contiguous()
        n = self.sizes[group]
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        self._count(group, out)
        dist.all_gather(list(out.chunk(n)), src, group=self.groups[group])
        return out.to(t.device) if via_host else out

    def all_gather_host(self, a: np.ndarray, group: str = "client"):
        """A numpy array from every rank of ``group``, concatenated on
        axis 0 in group order (through the card under NCCL)."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.host_device)
        return self.all_gather(t, group).cpu().numpy()

    def all_reduce_host(self, a: np.ndarray, group: str = "all",
                        op: str = "sum") -> np.ndarray:
        """A numpy array summed (or maxed) over ``group``."""
        t = torch.from_numpy(np.array(a)).to(self.host_device)
        return self.all_reduce(t, group, op).cpu().numpy()


class RecordingGrid(Grid):
    """A :class:`Grid`'s interface for a dry run on ``meta`` tensors: the
    rank is set explicitly and there is no process group. Each collective
    takes ``meta`` tensors, returns them unchanged (an all_gather returns
    a ``meta`` tensor of the gathered shape), counts them in ``stats`` as
    a real grid does, and appends ``{op, group, shape, dtype, bytes,
    site}`` to :attr:`calls` (``bytes``: the tensor's size, the result's
    for an all_gather; ``site``: the calling file, line and function). A
    tensor that is not on ``meta`` raises: this is never a stand-in for
    a real grid."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 rank: int = 0):
        axis_names, shape = tuple(axis_names), tuple(int(s) for s in shape)
        if axis_names not in LAYOUTS:
            raise ValueError(f"grid axes {axis_names} are not one of the "
                             f"reference's layouts {LAYOUTS}")
        if not 0 <= rank < int(np.prod(shape)):
            raise ValueError(f"rank {rank} is not on the grid {shape}")
        self._place(axis_names, shape, rank)
        self.backend = "recording"
        self.groups = {g: g for g in GROUPS}
        self.calls = []

    def __repr__(self):
        return f"RecordingGrid({self.shape}, rank={self.rank})"

    def _record(self, op: str, group: str, t: torch.Tensor) -> None:
        import traceback

        if t.device.type != "meta":
            raise ValueError(f"a RecordingGrid takes meta tensors, got one "
                             f"on {t.device}")
        self._count(group, t)
        site = next((f for f in reversed(traceback.extract_stack())
                     if not f.filename.endswith(("sharding/grid.py",))),
                    None)
        self.calls.append(dict(
            op=op, group=group, shape=tuple(t.shape), dtype=str(t.dtype),
            bytes=t.numel() * t.element_size(),
            site="?" if site is None else
            f"{site.filename.rsplit('/', 1)[-1]}:{site.lineno} {site.name}"))

    def all_reduce(self, t, group="all", op="sum"):
        self._record("all-reduce", group, t)
        return t

    def all_gather(self, t, group="client"):
        out = torch.empty((self.sizes[group] * t.shape[0],)
                          + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        self._record("all-gather", group, out)
        return out

    def all_gather_host(self, a, group="client"):
        raise ValueError("a RecordingGrid takes meta tensors, not host "
                         "arrays")

    all_reduce_host = all_gather_host


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def init_local_group(backend: str) -> bool:
    """A one-rank default process group over ``tcp://127.0.0.1:<free
    port>`` when none is initialized (``backend``: ``"gloo"`` or
    ``"nccl"``; NCCL's bootstrap then takes the loopback interface unless
    ``NCCL_SOCKET_IFNAME`` says otherwise). Returns whether it made one
    (the caller then destroys it with
    ``torch.distributed.destroy_process_group``)."""
    import os

    if dist.is_initialized():
        return False
    if backend == "nccl":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    return True


def make_host_grid(axis_names=("data", "model"), shape=None) -> Grid:
    """The counterpart of the reference's ``launch/mesh.py:
    make_host_mesh``: a ``(world, 1)`` ``("data", "model")`` grid over the
    initialized default group (gloo for CPU tensors, NCCL for CUDA), or
    ``shape`` over ``axis_names``."""
    if shape is None:
        shape = (dist.get_world_size(),) + (1,) * (len(axis_names) - 1)
    return Grid(axis_names, shape)


def spec_for(axes: Sequence[str], shape: Sequence[int], grid: Grid,
             rules=None):
    """The reference's ``spec_for``: each logical axis takes the first
    candidate group of mesh axes that exists, is unused by an earlier
    dimension and divides the size; otherwise it is replicated. Returns a
    spec tuple (trailing replicated entries dropped)."""
    rules = RULES_DP if rules is None else rules
    used, entries = set(), []
    if len(axes) != len(shape):
        raise ValueError(f"axes {tuple(axes)} against shape {tuple(shape)}")
    for name, dim in zip(axes, shape):
        choice = None
        for group in rules.get(name, ()):
            if not all(a in grid.shape for a in group):
                continue
            if any(a in used for a in group):
                continue
            if dim % int(np.prod([grid.shape[a] for a in group])):
                continue
            choice = group
            break
        if choice is None:
            entries.append(None)
        else:
            used.update(choice)
            entries.append(choice if len(choice) > 1 else choice[0])
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def tree_specs(axes_tree, shape_tree, grid: Grid, rules=None):
    """(logical-axes tree, shape tree) -> a tree of specs; a shape leaf is
    a tuple of ints or anything with ``.shape``."""
    return {k: (tree_specs(v, shape_tree[k], grid, rules)
                if isinstance(v, dict) else
                spec_for(v, getattr(shape_tree[k], "shape", shape_tree[k]),
                         grid, rules))
            for k, v in axes_tree.items()}


def round_specs(batch_specs):
    """Per-step batch specs -> per-round specs: the leading local-iteration
    axis T is never split (the reference's ``round_specs``)."""
    if isinstance(batch_specs, dict):
        return {k: round_specs(v) for k, v in batch_specs.items()}
    return (None,) + tuple(batch_specs)


def client_scalar_spec(grid: Grid, n: int):
    """The spec of a (K,) per-client schedule scalar: over the client
    axes, or replicated when K does not divide them (the reference's
    ``client_scalar_spec``)."""
    return spec_for(("client",), (n,), grid)
