"""ZeRO-1 optimizer-state and FSDP parameter layouts over a mesh's ``dp``
axis, and the bucket that carries a data-parallel step's gradients.

Counterpart of ``mpi_tpu/parallel/zero.py``. There a layout is a
``PartitionSpec`` that GSPMD plans the step around; here a spec is a plain
tuple with one entry per dimension (an axis name or None; ``()`` is
replicated), and the training step moves the data itself:
kernel 6 reduces or reduce-scatters the gradients and kernel 5 gathers the
parameters (``models/transformer.py``, ``make_train_parts``).

The rule per leaf is the JAX package's: start from the parameter's spec and
claim ``dp`` on the first dimension that is free, divisible by dp and at
least dp; a leaf with no such dimension stays replicated. ZeRO-1 matches
optimizer-state leaves to parameter specs by shape, as there.

A leaf with ``dp`` claimed on dimension ``dim`` is cut into n pieces along
it, piece r being rank r's shard: :func:`pieces_view` stacks them on a new
leading axis, ``(n, ..., k, ...)``, and :func:`unshard` puts them back
together. A piece keeps the leaf's dimension order, so a piece on a
dimension other than 0 is strided in the leaf: the claimed dimension's
rank index moves to the front before anything is flattened.

:class:`DpLayout` lays out every rank's pieces in one flat row of n chunks:
chunk j holds piece j of every sharded leaf (group by group, leaf by leaf,
each piece flattened in its own dimension order), and after the n chunks
come the replicated leaves whole, padded with zeros to a multiple of n.
Rank r's chunk is thus exactly its shards, which is what the ring's
reduce-scatter hands rank r.
"""

from __future__ import annotations

from typing import (Any, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

__all__ = ["Spec", "tree_leaves", "tree_with_leaves", "spec_leaves",
           "zero1_specs", "fsdp_specs", "spec_dim", "pieces_view", "unshard",
           "LeafPlace", "DpLayout", "grad_bucket", "allreduce_grads"]

Spec = Tuple[Any, ...]


class LeafPlace(NamedTuple):
    """Where a leaf lies in a :class:`DpLayout`: its full ``shape``, the
    ``dim`` dp claims (None: replicated), its ``group``, and its ``offset``
    inside a chunk (sharded) or inside the replicated part."""
    shape: torch.Size
    dim: Optional[int]
    group: int
    offset: int


def tree_leaves(tree: Any, nodes: Tuple[type, ...] = (list, tuple)
                ) -> List[Any]:
    """The leaves of ``tree`` in order: a dict (in key order) and any of
    ``nodes`` is a node, anything else a leaf. Every walk of a parameter,
    optimizer or spec tree in the port goes through here and
    :func:`tree_with_leaves`, so the bucket's layout and the leaves line
    up."""
    if isinstance(tree, dict):
        return [x for key in tree for x in tree_leaves(tree[key], nodes)]
    if isinstance(tree, nodes):
        return [x for node in tree for x in tree_leaves(node, nodes)]
    return [tree]


def tree_with_leaves(tree: Any, leaves: Iterator[Any],
                     nodes: Tuple[type, ...] = (list, tuple)) -> Any:
    """``tree``'s structure holding ``leaves`` (an iterator, consumed one
    per leaf in :func:`tree_leaves`' order)."""
    if isinstance(tree, dict):
        return {key: tree_with_leaves(node, leaves, nodes)
                for key, node in tree.items()}
    if isinstance(tree, nodes):
        return type(tree)(tree_with_leaves(node, leaves, nodes)
                          for node in tree)
    return next(leaves)


def spec_leaves(tree: Any) -> List[Spec]:
    """The specs of a spec tree in order: dicts and lists are nodes, a
    tuple is one spec."""
    return [tuple(s) for s in tree_leaves(tree, nodes=(list,))]


def _leaf_spec(shape: Tuple[int, ...], base: Optional[Spec], mesh: Any,
               axis: str) -> Spec:
    """``base`` (or fully unsharded) with ``axis`` claimed on the first
    free divisible dimension; unchanged when none qualifies."""
    if axis not in mesh.shape:
        return tuple(base) if base is not None else ()
    dp = mesh.shape[axis]
    entries = list(base) if base is not None else []
    entries += [None] * (len(shape) - len(entries))
    if axis in entries:  # already dp-sharded; nothing to claim
        return tuple(entries)
    if dp > 1:
        for i, (dim, cur) in enumerate(zip(shape, entries)):
            if cur is None and dim % dp == 0 and dim >= dp:
                entries[i] = axis
                break
    return tuple(entries)


def zero1_specs(params: Any, param_spec_tree: Any, opt_state: Any,
                mesh: Any, axis: str = "dp") -> Any:
    """The spec tree of ``opt_state`` (a tree of tensors, or of anything
    with a ``.shape``), each parameter-shaped leaf sharded over ``axis``.
    ``param_spec_tree`` mirrors ``params``; state leaves are matched to
    parameter specs by shape, as the JAX function does (any matching spec
    gives a layout consistent across ranks)."""
    shape_to_spec: Dict[Tuple[int, ...], Spec] = {}
    for p, s in zip(tree_leaves(params), spec_leaves(param_spec_tree)):
        shape_to_spec.setdefault(tuple(p.shape), s)

    def for_leaf(leaf):
        shape = tuple(leaf.shape)
        return _leaf_spec(shape, shape_to_spec.get(shape), mesh, axis)

    return tree_with_leaves(opt_state,
                            map(for_leaf, tree_leaves(opt_state)))


def fsdp_specs(params: Any, param_spec_tree: Any, mesh: Any,
               axis: str = "dp") -> Any:
    """The spec tree that shards the parameters themselves over ``axis``
    (ZeRO stage 3 / FSDP): on top of any tensor-parallel entry in
    ``param_spec_tree``, each parameter claims ``axis`` on its first free
    divisible dimension; leaves with none stay as they were."""
    specs = iter(spec_leaves(param_spec_tree))
    return tree_with_leaves(params, (
        _leaf_spec(tuple(p.shape), next(specs), mesh, axis)
        for p in tree_leaves(params)))


def spec_dim(spec: Spec, axis: str = "dp") -> Optional[int]:
    """The dimension ``spec`` shards over ``axis``, or None."""
    return spec.index(axis) if axis in spec else None


def pieces_view(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` cut into its n pieces along ``dim``, piece r (rank r's shard)
    at index r of a new leading axis: ``(n, ..., k, ...)``, a view
    (strided when ``dim`` is not 0)."""
    return x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)


def unshard(pieces: torch.Tensor, dim: int) -> torch.Tensor:
    """The full tensor from its stacked pieces (:func:`pieces_view`'s
    inverse), always a new contiguous tensor: a view of the pieces (which
    flattening gives when a piece is one slice thick) would make a
    reduction over it fold in another order than over the leaf itself."""
    n, shape = pieces.shape[0], list(pieces.shape[1:])
    shape[dim] *= n
    out = pieces.new_empty(shape)
    pieces_view(out, dim, n).copy_(pieces)
    return out


class DpLayout:
    """Where each leaf lies in a data-parallel bucket row (see the module
    note). ``groups`` holds, per group, its leaves' ``(shape, dim)`` in
    order, ``dim`` the dimension ``dp`` claims or None (replicated); ``n``
    is the dp size. Leaves are numbered across the groups in order.

    ``chunk`` values per rank chunk, ``spans[g]`` group g's ``(start,
    stop)`` inside a chunk, ``rest`` replicated values, ``width`` the
    row's length, ``n · chunk`` plus ``rest`` padded to a multiple of n."""

    def __init__(self, groups: Sequence[Sequence[Tuple[Sequence[int],
                                                       Optional[int]]]],
                 n: int):
        self.n = n
        self.leaves: List[LeafPlace] = []
        self.spans: List[Tuple[int, int]] = []
        chunk = rest = 0
        for g, leaves in enumerate(groups):
            start = chunk
            for shape, dim in leaves:
                shape = torch.Size(shape)
                if dim is None:
                    self.leaves.append(LeafPlace(shape, None, g, rest))
                    rest += shape.numel()
                else:
                    if shape[dim] % n:
                        raise ValueError(
                            f"mpi_tpu_torch: dimension {dim} of "
                            f"{tuple(shape)} does not split over {n} ranks")
                    self.leaves.append(LeafPlace(shape, dim, g, chunk))
                    chunk += shape.numel() // n
            self.spans.append((start, chunk))
        self.chunk, self.rest = chunk, rest
        self.width = n * chunk + -(-rest // n) * n

    def piece_shape(self, i: int) -> torch.Size:
        """Rank r's piece of sharded leaf ``i`` (the leaf's own shape for a
        replicated one)."""
        shape, dim = self.leaves[i].shape, self.leaves[i].dim
        if dim is None:
            return shape
        return shape[:dim] + (shape[dim] // self.n,) + shape[dim + 1:]

    def pieces(self, chunks: torch.Tensor, i: int,
               base: int = 0) -> torch.Tensor:
        """Sharded leaf ``i``'s pieces inside ``chunks`` ``(n, c)``, whose
        column 0 is chunk offset ``base``: a ``(n, *piece)`` view."""
        off = self.leaves[i].offset
        k = self.piece_shape(i).numel()
        return chunks[:, off - base:off - base + k].unflatten(
            1, self.piece_shape(i))

    def chunks(self, row: torch.Tensor) -> torch.Tensor:
        """The ``(n, chunk)`` sharded part of a bucket row."""
        return row[:self.n * self.chunk].view(self.n, self.chunk)

    def tail(self, row: torch.Tensor, i: int) -> torch.Tensor:
        """Replicated leaf ``i`` inside ``row``, a bucket row or its
        replicated part alone, as a view of the leaf's shape."""
        shape, off = self.leaves[i].shape, self.leaves[i].offset
        start = row.numel() - (self.width - self.n * self.chunk) + off
        return row[start:start + shape.numel()].view(shape)

    def pack(self, row: torch.Tensor, tensors: Sequence[torch.Tensor],
             add: bool = False) -> None:
        """Write (or, with ``add``, add) every leaf's full tensor into
        ``row`` (one bucket row, ``width`` values) at its place."""
        chunks = self.chunks(row)
        for i, x in enumerate(tensors):
            dim = self.leaves[i].dim
            dst = (self.tail(row, i) if dim is None
                   else self.pieces(chunks, i))
            src = x if dim is None else pieces_view(x, dim, self.n)
            if add:
                dst.add_(src)
            else:
                dst.copy_(src)

    def full(self, chunks: torch.Tensor, i: int, base: int = 0,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sharded leaf ``i``'s full tensor from its pieces inside
        ``chunks`` (as :meth:`pieces` reads them), into ``out`` if given,
        else into a new tensor."""
        shape, dim = self.leaves[i].shape, self.leaves[i].dim
        if out is None:
            out = chunks.new_empty(shape)
        pieces_view(out, dim, self.n).copy_(self.pieces(chunks, i, base))
        return out

    def unpack(self, row: torch.Tensor, i: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Leaf ``i``'s full tensor from ``row``, a bucket row (or, for a
        replicated leaf, its replicated part alone), into ``out`` if given,
        else into a new tensor."""
        if self.leaves[i].dim is not None:
            return self.full(self.chunks(row), i, out=out)
        src = self.tail(row, i)
        return src.clone() if out is None else out.copy_(src)

    def group_leaves(self, g: int, sharded: bool = False) -> List[int]:
        """The numbers of group ``g``'s leaves (its sharded ones alone
        with ``sharded``)."""
        return [i for i, leaf in enumerate(self.leaves) if leaf.group == g
                and not (sharded and leaf.dim is None)]


def grad_bucket(layout: DpLayout, device: Any) -> torch.Tensor:
    """An empty ``(n, width)`` float32 gradient bucket of ``layout`` on
    ``device``, row r for rank r's packed gradients, with the padding after
    the replicated leaves zeroed."""
    n = layout.n
    bucket = torch.empty((n, layout.width), dtype=torch.float32,
                         device=device)
    bucket[:, n * layout.chunk + layout.rest:].zero_()
    return bucket


def allreduce_grads(bucket: torch.Tensor, layout: DpLayout,
                    leaves: Sequence[torch.Tensor], ring: Any,
                    allreduce: Any) -> None:
    """Plain dp's reduction: one ``allreduce`` launch (kernel 6's wrapper,
    :func:`~mpi_tpu_torch.ops.ring_collectives.ring_allreduce`, as the
    caller's module binds it) sums ``bucket`` over ``ring``. Every rank's
    copy holds the same sum, so the replicated parameters take one update:
    rank 0's copy, over n, becomes the ``.grad`` of each of ``leaves``."""
    total = allreduce(bucket, ring)[0].div_(layout.n)
    for i, x in enumerate(leaves):
        x.grad = layout.unpack(total, i)
