"""Logical-axis → mesh-axis sharding rules on ``DeviceMesh`` / ``DTensor``
(port of ``repro.parallel.sharding``).

Parameters declare *logical* axis names in their PDefs; this module turns
them into a spec for a concrete mesh, and a spec into DTensor placements.
A spec is a tuple with one entry per tensor dim: ``None`` (replicated), a
mesh axis name, or a tuple of names (the batch dim over ``("pod",
"data")``).  Assignment is the reference's greedy order: each logical axis
tries its candidate mesh axes in order, skipping axes already used by an
earlier dim of the same tensor and axes that do not divide the dim size.
That one mechanism expresses:

* TP   — "heads"/"ffn"/"vocab" → model
* EP   — "experts" → model (expert FFN dims then fall through to data/pod)
* FSDP — with ``fsdp=True``, "embed" (and overflow "ffn") shard over data
         (and pod on the multi-pod mesh)
* DP   — "batch" on activations → (pod, data)
* SP   — "kv_seq" on long-context caches/activations → model

The rules are pure functions of a PDef and the mesh's axis sizes, so they
run without a process group.  The functions that read a mesh take a
``DeviceMesh``, a mapping of axis name to size, or any object with
``axis_names`` and ``devices`` (the shape of a JAX ``Mesh``).

``placements`` maps a spec onto a ``DeviceMesh``: a tensor dim whose entry
names mesh axis ``a`` is ``Shard(dim)`` on ``a``'s mesh dim, every other
mesh dim is ``Replicate()``; an entry ``("pod", "data")`` is ``Shard(d)``
on both, in mesh order, which is the order a JAX ``PartitionSpec`` shards
in.  ``constrain`` is the reference's ``with_sharding_constraint``: a
``DTensor.redistribute`` to the size-aware spec.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.nn.params import PDef, flat_defs

Spec = Tuple[object, ...]


def _candidates(fsdp: bool) -> Dict[Optional[str], Tuple[str, ...]]:
    return {
        None: (),
        "layers": (),
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        # "data" fallback: when `model` is taken by the experts dim (EP), the
        # expert FFN dim shards over data; under FSDP, pod is the overflow.
        "ffn": ("model", "data", "pod") if fsdp else ("model", "data"),
        "experts": ("model",),
        "embed": ("data", "pod") if fsdp else (),
        "state": (),
        "kv_seq": ("model",),
        "batch": ("pod", "data"),   # params never use this; activations do
        "hidden": (),
        "cell_in": (),
        "cell_out": (),
    }


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, a mapping, or an object
    with ``axis_names`` and ``devices`` (a JAX ``Mesh`` or a stand-in)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, np.shape(mesh.devices)))


def spec_for(defn: PDef, mesh_axes: Mapping[str, int], fsdp: bool) -> Spec:
    """The spec of one PDef on a mesh of ``mesh_axes`` sizes."""
    cands = _candidates(fsdp)
    used: set = set()
    out: List[object] = []
    for dim, name in zip(defn.shape, defn.axes):
        if name == "batch":
            # batch shards over the full DP product: ("pod", "data")
            axes = []
            rem = dim
            for ax in cands["batch"]:
                if ax in mesh_axes and ax not in used and rem % mesh_axes[ax] == 0:
                    axes.append(ax)
                    used.add(ax)
                    rem //= mesh_axes[ax]
            out.append(tuple(axes) if len(axes) > 1 else (axes[0] if axes else None))
            continue
        assigned = None
        for ax in cands.get(name, ()):  # unknown logical names -> replicated
            if ax in mesh_axes and ax not in used and dim % mesh_axes[ax] == 0:
                assigned = ax
                used.add(ax)
                break
        out.append(assigned)
    return tuple(out)


def _map_defs(fn, defs):
    if isinstance(defs, PDef):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def param_specs(defs, mesh, fsdp: bool = False):
    """The spec of every PDef of ``defs``, in the same nesting."""
    axes = mesh_sizes(mesh)
    return _map_defs(lambda d: spec_for(d, axes, fsdp), defs)


def placements(spec: Sequence[object], mesh, shape: Optional[Sequence[int]] = None
               ) -> List[object]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim.  Given
    the tensor's ``shape``, a dim of size 1 stays replicated: only an axis
    of size 1 can "shard" it (a batch of 1 on a one-device mesh), and
    DTensor cannot drop such a dim in a view."""
    from torch.distributed.tensor import Replicate, Shard

    out: List[object] = [Replicate() for _ in mesh.mesh_dim_names]
    for dim, entry in enumerate(spec):
        if entry is None or (shape is not None and shape[dim] == 1):
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            out[mesh.mesh_dim_names.index(ax)] = Shard(dim)
    return out


def param_shardings(defs, mesh, fsdp: bool = False):
    """The placements of every PDef of ``defs`` on ``mesh``, in the same
    nesting (the reference's ``NamedSharding`` tree)."""
    axes = mesh_sizes(mesh)
    return _map_defs(lambda d: placements(spec_for(d, axes, fsdp), mesh, d.shape), defs)


def local_shape(shape: Sequence[int], spec: Sequence[object],
                mesh_axes: Mapping[str, int]) -> Tuple[int, ...]:
    """Each rank's shape of a ``shape`` tensor under ``spec`` (the rules
    only shard dims the axes divide, so every rank's shape is the same)."""
    out = []
    for dim, entry in zip(shape, spec):
        for ax in (() if entry is None else
                   entry if isinstance(entry, tuple) else (entry,)):
            dim //= mesh_axes[ax]
        out.append(dim)
    return tuple(out)


def distribute(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """``t``, held whole by every rank, as a DTensor under ``place``: each
    rank keeps its own slice and nothing is sent (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, place, src_data_rank=None)


# ---------------------------------------------------------------- activations
def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the batch dim: ('pod','data') or ('data',)."""
    sizes = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def batch_dim_spec(dim: int, mesh):
    """DP axes that actually divide this batch size (batch=1 ⇒ replicate)."""
    sizes = mesh_sizes(mesh)
    axes = []
    rem = dim
    for a in batch_axes(mesh):
        if rem % sizes[a] == 0:
            axes.append(a)
            rem //= sizes[a]
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def act_spec(mesh, *axes: Optional[str]) -> Spec:
    """An activation spec: 'batch'→(pod,data), 'model'→model."""
    sizes = mesh_sizes(mesh)
    out: List[object] = []
    for a in axes:
        if a == "batch":
            ba = batch_axes(mesh)
            out.append(ba if len(ba) > 1 else (ba[0] if ba else None))
        else:
            out.append(a if a in sizes else None)
    return tuple(out)


def constrain_spec(shape: Sequence[int], mesh, *axes: Optional[str]) -> Spec:
    """The size-aware spec :func:`constrain` gives a tensor of ``shape``."""
    sizes = mesh_sizes(mesh)
    out: List[object] = []
    for dim, a in zip(shape, axes):
        if a == "batch":
            out.append(batch_dim_spec(dim, mesh))
        elif a in sizes and dim % sizes[a] == 0:
            out.append(a)
        else:
            out.append(None)
    return tuple(out)


def constrain(x, mesh, *axes: Optional[str]):
    """The reference's ``with_sharding_constraint`` via logical activation
    axes (size-aware): ``x`` redistributed to that spec.  ``x`` as it is
    when ``mesh`` is None; a plain tensor (held whole by every rank) is
    distributed without communication."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    place = placements(constrain_spec(x.shape, mesh, *axes), mesh, x.shape)
    if not isinstance(x, DTensor):
        return distribute(x, mesh, place)
    if list(x.placements) == place:
        return x
    return x.redistribute(mesh, place)


@contextlib.contextmanager
def mesh_context(mesh):
    """With a mesh, plain tensors met beside DTensors (positions, masks and
    zeros made inside a forward) count as replicated on it
    (``implicit_replication``); nested uses keep the outer one in force.
    Without a mesh, nothing."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    if getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False):
        yield
        return
    with implicit_replication():
        yield


def is_sharded(x, dim: int) -> bool:
    """Whether ``x`` is a DTensor sharded along tensor dim ``dim``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return False
    dim %= x.dim()
    return any(p.is_shard(dim) for p in x.placements)


def split_ready(x, dim: int, outer: int):
    """``x`` ready for a view that splits tensor dim ``dim`` into
    ``(outer, ...)``: DTensor keeps a shard only on the split's outer factor
    and only when its shard count divides ``outer``; otherwise that dim is
    gathered first (ROADMAP C18).  A plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    n = 1
    for p, size in zip(x.placements, x.device_mesh.shape):
        if p.is_shard(dim):
            n *= size
    return x if outer % n == 0 else replicate_dims(x, [dim])


class _SplitReadyGrad(torch.autograd.Function):
    """Identity whose backward applies :func:`split_ready` to the gradient."""

    @staticmethod
    def forward(ctx, x, dim: int, outer: int):
        ctx.dim, ctx.outer = dim, outer
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return split_ready(g, ctx.dim, ctx.outer), None, None


def grad_split_ready(x, dim: int, outer: int):
    """``x``, whose gradient is made :func:`split_ready` for the split that
    the backward of a merging view (``(outer, ...)`` into dim ``dim``) runs
    on it (ROADMAP C18).  A plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or not torch.is_grad_enabled():
        return x
    return _SplitReadyGrad.apply(x, dim, outer)


class _GradLike(torch.autograd.Function):
    """Identity whose backward places the gradient as the forward's input."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.place = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        if isinstance(g, DTensor) and tuple(g.placements) != ctx.place:
            return g.redistribute(ctx.mesh, ctx.place)
        return g


def grad_like(x):
    """``x``, whose gradient is redistributed to ``x``'s own placements
    before it flows on.  SP attention hands the queries a gradient pending
    a sum over the T shards; left so, DTensor reduce-scatters it along the
    sequence, which the projection's matmul folds into its (B·S) rows and,
    on a mesh that also shards the batch over two dims, cannot split back
    (ROADMAP C18).  A plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or not torch.is_grad_enabled():
        return x
    return _GradLike.apply(x)


class _Cumsum(torch.autograd.Function):
    """``torch.cumsum`` whose backward sums the gradient from the end
    without ``flip``."""

    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.dim = dim
        return torch.cumsum(x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        d = ctx.dim
        return g + (torch.sum(g, dim=d, keepdim=True) - torch.cumsum(g, dim=d)), None


def cumsum(x, dim: int):
    """``torch.cumsum(x, dim)``.  On a DTensor the backward is the suffix
    sum ``g + (sum(g) - cumsum(g))``: torch's own backward flips the
    gradient, and DTensor has no ``flip`` rule in some torch versions (2.11;
    ROADMAP C18).  A plain tensor takes ``torch.cumsum`` itself."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or not torch.is_grad_enabled():
        return torch.cumsum(x, dim=dim)
    return _Cumsum.apply(x, dim % x.dim())


class _Dense(torch.autograd.Function):
    """``x`` and its gradient with contiguous local shards."""

    @staticmethod
    def forward(ctx, x):
        return x.contiguous() if not x.to_local().is_contiguous() else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        if isinstance(g, DTensor) and not g.to_local().is_contiguous():
            return g.contiguous()
        return g


def dense(x):
    """``x`` with a contiguous local shard, and a gradient made so too, when
    it is a DTensor: an ``einsum`` whose DTensor operand or output gradient
    has a permuted local layout fails in its backward (a ``view`` across
    strides), so the mesh path copies them first (ROADMAP C18).  A plain
    tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    if not torch.is_grad_enabled():
        return x.contiguous()
    return _Dense.apply(x)


def zeros(shape, dtype, device, mesh=None, place=None):
    """Zeros of ``shape``: a plain tensor on ``device``, or with a mesh a
    DTensor under ``place`` whose ranks allocate their shards only (on
    ``meta``, nothing)."""
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    if torch.device(device).type == "meta":
        return distribute(torch.zeros(shape, dtype=dtype, device="meta"), mesh, place)
    from torch.distributed import tensor as dt

    return dt.zeros(tuple(shape), dtype=dtype, device_mesh=mesh, placements=place)


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.device.type == "meta" or (
        a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr())


def assign(dst, idx, src) -> None:
    """``dst[idx] = src`` in place.  A DTensor ``dst`` is written on each
    rank's shard: ``src`` is placed like ``dst[idx]``, which must leave every
    sharded dim whole (the caches' layer, batch and row slices do)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(dst, DTensor):
        dst[idx] = src
        return
    view = dst[idx]
    if not _same_storage(view.to_local(), dst.to_local()):
        raise ValueError(f"assign: {idx} cuts a sharded dim of {dst.placements}")
    view.to_local().copy_(_placed_like(src, view).to_local())


def _placed_like(src, like):
    """``src`` (a DTensor, or a plain tensor every rank holds whole) as a
    DTensor under ``like``'s placements on its mesh."""
    from torch.distributed.tensor import DTensor

    mesh, place = like.device_mesh, list(like.placements)
    if not isinstance(src, DTensor):
        return distribute(src, mesh, place)
    return src if list(src.placements) == place else src.redistribute(mesh, place)


def write_row(cache, dim: int, at, row) -> None:
    """``cache.index_copy_(dim, at, row)`` for one position ``at`` (a 0-d
    integer tensor on the device, read without a sync).  On a DTensor cache
    ``row`` is placed like the cache and each rank writes its shard; when
    ``dim`` itself is sharded (SP), the rank whose rows hold ``at`` writes
    it, by a masked copy over its rows."""
    from torch.distributed.tensor import DTensor

    at = at.reshape(1).long()
    if not isinstance(cache, DTensor):
        cache.index_copy_(dim, at, row)
        return
    at = at.to_local() if isinstance(at, DTensor) else at
    row = _placed_like(row, cache).to_local()
    loc = cache.to_local()
    if not is_sharded(cache, dim):
        loc.index_copy_(dim, at, row)
        return
    n, offset = loc.shape[dim], 0
    coord = cache.device_mesh.get_coordinate()
    for i, p in enumerate(cache.placements):   # outer mesh dims first
        if p.is_shard(dim):
            offset = offset * cache.device_mesh.size(i) + coord[i]
    pos = torch.arange(n, device=loc.device) + offset * n
    hit = (pos == at).reshape([n if d == dim else 1 for d in range(loc.dim())])
    loc.copy_(torch.where(hit, row, loc))


def gather_rows(table, ids):
    """``table[ids]`` (an embedding lookup) on a mesh: the table is gathered
    whole on every rank (an all-gather where it is sharded) and each rank
    indexes it with its own ids, so the result is placed like ``ids`` (and
    replicated along the rows' own dims); the table's gradient is a pending
    sum (``Partial``) over the mesh dims that shard ``ids``.  DTensor's own
    rule for the lookup's backward (``index_put``) fails in some torch
    versions (ROADMAP C18).  Plain tensors index as they are."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(table, DTensor) and not isinstance(ids, DTensor):
        return table[ids]
    mesh = (table if isinstance(table, DTensor) else ids).device_mesh
    rep = [Replicate()] * mesh.ndim
    place = list(ids.placements) if isinstance(ids, DTensor) else rep
    if isinstance(table, DTensor):
        whole = table if list(table.placements) == rep else table.redistribute(mesh, rep)
        table = whole.to_local(grad_placements=[Partial() if p.is_shard() else Replicate()
                                                for p in place])
    local = ids.to_local() if isinstance(ids, DTensor) else ids
    return DTensor.from_local(table[local], mesh, place, run_check=False)


def local_heads(q, k, v, n_kv: int):
    """``(q, (q_local, k_local, v_local), n_kv_local)`` when attention over
    q (B, S, N, hd) and k, v (B, T, K, hd) can run on each rank's shards
    alone, else None (the DTensor ops run, SP attention among them).

    All three must be DTensors with no pending sum, sharded only along the
    batch (alike) and the head dims, and each rank must hold whole GQA
    groups or a part of one: K/V sharded like q with the head shards
    dividing K, or K/V whole along the head dims while q's one head-sharded
    mesh dim gives each rank a run of heads inside one group or made of
    whole groups (each rank then takes the K/V heads its queries read, and
    the K/V gradients sum over that mesh dim).  Attention is independent
    per (batch, head), so the local computation is the global one's slice,
    and no DTensor op runs inside the q-chunk loop (ROADMAP C18)."""
    from torch.distributed.tensor import DTensor, Partial

    if not all(isinstance(t, DTensor) for t in (q, k, v)):
        return None
    if list(k.placements) != list(v.placements):
        return None
    mesh, n = q.device_mesh, q.shape[2]
    head_dims = []
    for i, (p, kp) in enumerate(zip(q.placements, k.placements)):
        if p.is_partial() or kp.is_partial() or p.is_shard(0) != kp.is_shard(0):
            return None
        if any(t.is_shard() and t.dim not in (0, 2) for t in (p, kp)):
            return None
        if kp.is_shard(2) and not p.is_shard(2):
            return None
        if p.is_shard(2):
            head_dims.append((i, kp.is_shard(2)))
    shards = 1
    for i, _ in head_dims:
        shards *= mesh.size(i)
    if all(kv_sharded for _, kv_sharded in head_dims):
        if n_kv % shards:
            return None
        return q, (q.to_local(), k.to_local(), v.to_local()), n_kv // shards
    if len(head_dims) != 1 or head_dims[0][1]:
        return None
    i = head_dims[0][0]
    g, nl = n // n_kv, n // shards
    if nl % g and g % nl:
        return None
    r = mesh.get_coordinate()[i]
    k0, k1 = (r * nl) // g, ((r + 1) * nl - 1) // g + 1
    grad = [Partial() if j == i else p for j, p in enumerate(k.placements)]
    kl = k.to_local(grad_placements=grad)[:, :, k0:k1]
    vl = v.to_local(grad_placements=grad)[:, :, k0:k1]
    return q, (q.to_local(), kl, vl), k1 - k0


def local_rows(t, like):
    """Rank's rows of ``t`` (held whole by every rank, or a DTensor) along
    dim 0 where the DTensor ``like`` shards its dim 0."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    place = [Shard(0) if p.is_shard(0) else Replicate() for p in like.placements]
    if isinstance(t, DTensor):
        return t.redistribute(like.device_mesh, place).to_local()
    return distribute(t, like.device_mesh, place).to_local()


def from_local_like(t: torch.Tensor, like):
    """The local ``t`` as a DTensor placed like ``like`` (even shards)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, like.device_mesh, like.placements, run_check=False)


def replicate_partial(x):
    """``x`` with every pending sum (``Partial``) reduced to ``Replicate``;
    a plain tensor, or one with nothing pending, as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    place = [Replicate() if p.is_partial() else p for p in x.placements]
    return x if place == list(x.placements) else x.redistribute(x.device_mesh, place)


def replicate_dims(x, dims: Sequence[int]):
    """``x`` with every mesh dim that shards one of tensor dims ``dims``
    gathered (``Replicate``): what a view that splits a sharded dim needs
    when DTensor cannot keep the shard on the split's outer factor
    (ROADMAP C18).  A plain tensor, or one not sharded there, is returned
    as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dims = {d % x.dim() for d in dims}
    place = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
             for p in x.placements]
    if place == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, place)


def shard_batch(x: torch.Tensor, mesh):
    """Place a host batch on the mesh, dim 0 sharded over the DP axes (each
    rank holds the whole batch and keeps its rows)."""
    spec = (batch_dim_spec(x.shape[0], mesh),) + (None,) * (x.dim() - 1)
    return distribute(x, mesh, placements(spec, mesh, x.shape))


def pad_batch(x, n_rows: int):
    """Zero-pad dim 0 of a host batch up to ``n_rows``.

    The serving scheduler coalesces requests into power-of-two buckets so
    kernel B4 sees a few batch sizes only, and every bucket size divides the
    DP axes of any power-of-two mesh; this is the padding step (zero codes
    are always valid inputs — the integer engines accept any in-range code
    and padded rows are dropped at scatter time).
    """
    if x.shape[0] > n_rows:
        raise ValueError(f"batch of {x.shape[0]} rows does not fit a "
                         f"{n_rows}-row bucket")
    if x.shape[0] == n_rows:
        return x
    pad = [(0, n_rows - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(np.asarray(x), pad)


def replica_meshes(mesh, n_replicas: int):
    """Partition a mesh's ranks into ``n_replicas`` per-replica meshes.

    When the rank count divides evenly, each replica gets a 1-D
    ``("data",)`` mesh over its contiguous slice of ranks — the shape
    ``launch.mesh.make_local_mesh`` builds, so ``shard_batch`` applies
    unchanged per replica (every rank of the world must call this, as it
    makes the sub-meshes' groups).  When they do not divide (including the
    one-rank mesh of one card), every replica gets the original mesh (or
    ``None``) and the replicas time-multiplex.
    """
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if mesh is None:
        return [None] * n_replicas
    from torch.distributed.device_mesh import DeviceMesh

    ranks = mesh.mesh.flatten().tolist()
    if len(ranks) < n_replicas or len(ranks) % n_replicas:
        return [mesh] * n_replicas
    per = len(ranks) // n_replicas
    return [DeviceMesh(mesh.device_type, ranks[k * per:(k + 1) * per],
                       mesh_dim_names=("data",))
            for k in range(n_replicas)]


def heads_shardable(n_heads: int, mesh) -> bool:
    axes = mesh_sizes(mesh)
    return "model" in axes and n_heads % axes["model"] == 0


def flat_placements(defs, mesh, fsdp: bool = False) -> Dict[str, List[object]]:
    """:func:`param_shardings` by ``/``-joined path (``blocks/wq``)."""
    axes = mesh_sizes(mesh)
    return {k: placements(spec_for(d, axes, fsdp), mesh, d.shape)
            for k, d in flat_defs(defs).items()}
