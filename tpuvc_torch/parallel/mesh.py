"""Data parallelism over processes (port of tpuvc.parallel.mesh).

tpuvc places arrays on a 1-D ``("data",)`` device mesh and lets XLA compile
one SPMD program whose outputs are logical full arrays. The port runs one
process per device, launched by ``python -m torch.distributed.run``
(torchrun), and keeps tpuvc's names and contracts with the placement made
explicit: "shard this batch over the mesh" becomes "this rank computes these
rows", followed by a gather in row order.

- :func:`make_mesh` joins the process group torchrun's environment
  describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``) and
  returns a :class:`Mesh`: its size, this rank, this rank's device.
- :func:`shard_batch` takes this rank's contiguous rows, :func:`replicate`
  broadcasts rank 0's tensors, :func:`level_batch_sharder` is the coders'
  rule for real-bitstream level batches, :func:`shard_eval` pads, computes
  and gathers a batched forward.

Transport: NCCL on CUDA, gloo on the CPU, unless the caller names one. Ranks
that share a card must name gloo (NCCL refuses two ranks on one GPU, and
that error is left to surface). gloo moves CUDA tensors through host copies
made here, one path for every collective.

``shard_spatial`` (H sharded across devices) lives in
:mod:`tpuvc_torch.parallel.spatial`: explicit row fetches between the ranks
take the place of the halo exchanges XLA's partitioner inserts, and every
family's forward runs there with its rows sharded (``spatial_forward``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any

import torch
import torch.distributed as dist

from tpuvc_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``size`` processes, one device each; this process is
    ``rank`` on ``device``. ``group`` is None for a one-device mesh made
    without a process group (no collective then runs)."""

    size: int
    rank: int
    device: torch.device
    axis: str = "data"
    group: Any = None
    backend: str | None = None
    owns_group: bool = False

    def close(self) -> None:
        """Leave the process group if :func:`make_mesh` created it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def world_size() -> int:
    """The launch's process count: the group's if one exists, else
    torchrun's ``WORLD_SIZE`` (1 without it)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_mesh(n_devices: int | None = None, axis: str = "data", backend: str | None = None,
              device=None) -> Mesh:
    """The mesh of this launch's processes.

    ``n_devices`` must equal the launch's world size (a mesh never
    truncates: the stream header records its size). ``device`` is ``cuda``
    by default (no quiet fallback to the CPU): a rank's card is
    ``cuda:(LOCAL_RANK % device_count)``; pass ``"cpu"`` to run on the CPU.
    ``backend`` defaults to ``nccl`` on CUDA and ``gloo`` on the CPU. An
    existing default group is joined as it is; a ``backend`` other than its
    own raises.
    """
    world = world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs WORLD_SIZE={n}, but this launch has "
                         f"WORLD_SIZE={world}: launch one process per device with "
                         f"python -m torch.distributed.run --nproc_per_node {n}")
    initialized = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if initialized else int(os.environ.get("RANK", "0"))
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if initialized:
        have = dist.get_backend()
        if backend is not None and backend != have:
            raise ValueError(f"the process group runs {have}, not the {backend} asked for")
        return Mesh(n, rank, dev, axis, dist.group.WORLD, have)
    if "WORLD_SIZE" not in os.environ:
        # One process and no launcher: a one-device mesh, no group.
        return Mesh(1, 0, dev, axis)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=n)
    return Mesh(n, rank, dev, axis, dist.group.WORLD, backend, owns_group=True)


# -- collectives ------------------------------------------------------------


def _staged(mesh: Mesh, fn, tensors: list) -> list:
    """Run collective ``fn`` on ``tensors``, through host copies where gloo
    meets CUDA tensors, and with gloo's 16-bit floats widened to float32
    (exact both ways; gloo has no bfloat16). Returns the results on the
    tensors' own device and dtype."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    moved = [t.detach().contiguous() for t in tensors]
    if mesh.backend == "gloo":
        if dev.type == "cuda":
            moved = [t.cpu() for t in moved]
        if dtype in (torch.bfloat16, torch.float16):
            moved = [t.float() for t in moved]
    return [t.to(dev, dtype) for t in fn(moved)]


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's ``x`` along dim 0, in rank order (equal
    shapes on every rank)."""
    if mesh.group is None:
        return x

    def gather(ts):
        parts = [torch.empty_like(ts[0]) for _ in range(mesh.size)]
        dist.all_gather(parts, ts[0], group=mesh.group)
        return [torch.cat(parts)]

    return _staged(mesh, gather, [x])[0]


def all_reduce_mean(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks (a sum, then a division by the
    size: one order of float additions on every rank)."""
    if mesh.group is None:
        return x

    def reduce(ts):
        dist.all_reduce(ts[0], op=dist.ReduceOp.SUM, group=mesh.group)
        return ts

    return _staged(mesh, reduce, [x.clone()])[0] / mesh.size


def broadcast_(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` in place with rank ``src``'s values."""
    if mesh.group is None:
        return t

    def bcast(ts):
        dist.broadcast(ts[0], src=src, group=mesh.group)
        return ts

    with torch.no_grad():
        t.copy_(_staged(mesh, bcast, [t])[0])
    return t


def all_gather_objects(mesh: Mesh, obj) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if mesh.group is None:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


# -- placement --------------------------------------------------------------


def _tree_map(fn, tree):
    """``fn`` over the tensors of a tree of dicts, lists, tuples and
    dataclass instances; other leaves pass through."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _rows(mesh: Mesh, b: int) -> slice:
    per = b // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, tree):
    """This rank's contiguous rows ``[r*B/n, (r+1)*B/n)`` of every tensor in
    ``tree`` (views). Raises when ``n`` does not divide a batch, as a
    sharding over a non-divisible axis does in JAX."""
    def take(x):
        if x.shape[0] % mesh.size:
            raise ValueError(f"batch {x.shape[0]} does not divide over a mesh of {mesh.size}")
        return x[_rows(mesh, x.shape[0])]

    return _tree_map(take, tree)


def replicate(mesh: Mesh, tree):
    """Rank 0's values in every tensor of ``tree``, on every rank (an
    in-place broadcast, in the tree's order): parameters and optimizer state
    then agree bit for bit."""
    return _tree_map(lambda t: broadcast_(mesh, t), tree)


class LevelBatchSharder:
    """The split rule for real-bitstream level-batched coding (tpuvc's
    ``level_batch_sharder``): a pure function of (batch, mesh size), so an
    encoder and a decoder over meshes of one size decide alike.

    ``B % n == 0``: this rank codes its ``B/n`` rows, and :meth:`gather`
    all-gathers them in row order. Otherwise every rank codes all ``B``
    rows (tpuvc's "replicated"; no padding: a coded frame cannot be
    dropped) and nothing moves. Either way every rank ends a level with the
    full reconstructions, the references of later levels.
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def is_split(self, b: int) -> bool:
        return b % self.mesh.size == 0

    def rows(self, b: int) -> slice:
        """This rank's rows of a level batch of ``b``."""
        return _rows(self.mesh, b) if self.is_split(b) else slice(0, b)

    def __call__(self, x, b: int | None = None):
        """This rank's rows of a level batch of ``b`` (by default ``x``'s
        length): of a tensor, a list (per-frame streams) or a tuple of
        them."""
        if isinstance(x, tuple):
            return tuple(self(v, b if b is not None else len(x[0])) for v in x)
        return x[self.rows(len(x) if b is None else b)]

    def gather(self, x: torch.Tensor, b: int) -> torch.Tensor:
        """The level's full ``(b, ...)`` batch from this rank's rows."""
        return all_gather_rows(self.mesh, x) if self.is_split(b) else x

    def gather_list(self, items: list, b: int) -> list:
        """The level's ``b`` per-frame objects (streams) from this rank's."""
        if not self.is_split(b):
            return items
        return [x for part in all_gather_objects(self.mesh, items) for x in part]


def level_batch_sharder(mesh: Mesh) -> LevelBatchSharder:
    """The coders' rule over ``mesh`` (``coder.set_shard(...)``)."""
    return LevelBatchSharder(mesh)


def shard_eval(mesh: Mesh, fn):
    """Data-parallel wrapper for a batched eval forward: ``fn`` takes tensors
    with a common leading batch dim and returns a tree of tensors with that
    dim. The batch is padded by repeating its last row up to a multiple of
    the mesh size, this rank computes its chunk, the chunks are all-gathered
    in row order and the padded rows dropped."""
    def wrapped(*args):
        b = args[0].shape[0]
        pad = (-b) % mesh.size
        if pad:
            args = tuple(torch.cat([a, a[-1:].expand(pad, *a.shape[1:])]) for a in args)
        out = fn(*shard_batch(mesh, args))
        return _tree_map(lambda x: all_gather_rows(mesh, x)[:b], out)

    return wrapped


# -- the coders' level-batch entry points -----------------------------------


def _split_args(shard: LevelBatchSharder, b: int, args):
    return [shard(a, b) if torch.is_tensor(a) or isinstance(a, list) else a for a in args]


def sharded_level_encode(method):
    """Decorate a coder's ``encode_level_batch_async(x..., **rates)`` ->
    ``(resolve, x_hat)``: with ``self.shard`` set, the method runs on this
    rank's rows, ``x_hat`` is gathered before it returns and ``resolve()``
    gathers the per-frame streams."""
    @functools.wraps(method)
    def wrapped(self, *args, **kw):
        shard = self.shard
        if shard is None:
            return method(self, *args, **kw)
        b = next(a for a in args if torch.is_tensor(a)).shape[0]
        resolve, x_hat = method(self, *_split_args(shard, b, args), **kw)
        return (lambda: shard.gather_list(resolve(), b)), shard.gather(x_hat, b)

    return wrapped


def sharded_level_decode(method):
    """Decorate a coder's ``decode_level_batch(xref1, xref2, bitstreams)``:
    with ``self.shard`` set, this rank decodes its rows' streams against its
    rows of the references, and the reconstructions are gathered."""
    @functools.wraps(method)
    def wrapped(self, *args, **kw):
        shard = self.shard
        if shard is None:
            return method(self, *args, **kw)
        b = len(next(a for a in args if isinstance(a, list)))
        return shard.gather(method(self, *_split_args(shard, b, args), **kw), b)

    return wrapped


def sharded_level_decode_async(method):
    """Decorate a coder's ``decode_level_batch_async(bitstreams)`` ->
    ``resolve(x_before, x_after)``: with ``self.shard`` set, this rank
    entropy-decodes only its rows' streams, and ``resolve`` runs on its rows
    of the references and gathers the reconstructions."""
    @functools.wraps(method)
    def wrapped(self, bitstreams, **kw):
        shard = self.shard
        if shard is None:
            return method(self, bitstreams, **kw)
        b = len(bitstreams)
        resolve = method(self, shard(bitstreams, b), **kw)

        def resolve_rows(x_before, x_after):
            return shard.gather(resolve(*shard((x_before, x_after), b)), b)

        return resolve_rows

    return wrapped
