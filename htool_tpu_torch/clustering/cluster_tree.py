"""Geometric cluster trees — host-side planner.

A copy of ``htool_tpu/clustering/cluster_tree.py``: the port never imports
the JAX package, so its host planners are copied, not shared.  As there,
``backend="auto"`` (the default) builds the tree with the C++ planner of
:mod:`htool_tpu_torch.native` and falls back to the NumPy builder below when
the planner does not build; the two backends give different permutations.

The cluster tree is built once on the host in NumPy and is consumed as flat
integer arrays by the block-tree planner.  The device never sees tree
pointers — only the permutation (as gather indices) and block offset/size
tables derived from this structure.

Behavioral reference: ``include/htool/clustering/tree_builder/tree_builder.hpp``
(stack-based build, partition modes at :52-207, weighted center/radius at
:209-253) and ``include/htool/clustering/implementations/partitioning.hpp``
(PCA / bounding-box directions :159-231, regular / geometric splitting
:233-296).  Node metadata mirrors ``clustering/cluster_node.hpp:16-82``
(offset/size/rank/counter + shared global permutation).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = [
    "ClusterTree",
    "ClusterTreeBuilder",
    "build_cluster_tree",
]


@dataclass
class ClusterTree:
    """Flat-array cluster tree over a point cloud.

    Nodes are stored in build (stack/DFS) order; node 0 is the root.  All
    arrays are host NumPy.  ``permutation`` maps cluster numbering to user
    numbering: ``user_index = permutation[cluster_index]`` (same convention as
    the reference's global permutation, ``cluster_node.hpp:99-175``).
    """

    # geometry (user numbering)
    points: np.ndarray  # [N, dim]
    # permutation: cluster numbering -> user numbering
    permutation: np.ndarray  # [N] int64
    # per-node arrays
    offsets: np.ndarray  # [n_nodes] start in cluster numbering
    sizes: np.ndarray  # [n_nodes]
    depths: np.ndarray  # [n_nodes]
    parents: np.ndarray  # [n_nodes], -1 for root
    child_start: np.ndarray  # [n_nodes] index into `children`; leaves: count==0
    child_count: np.ndarray  # [n_nodes]
    children: np.ndarray  # [sum child_count] node ids, ordered
    centers: np.ndarray  # [n_nodes, dim]
    radii: np.ndarray  # [n_nodes]
    ranks: np.ndarray  # [n_nodes] partition id; -1 above the partition level
    counters: np.ndarray  # [n_nodes] level-wise counter (reference semantics)
    # partition info
    partition_roots: np.ndarray  # [P] node ids (clusters_on_partition)
    is_permutation_local: bool = False
    max_leaf_size: int = 128

    # ------------------------------------------------------------------
    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])

    @property
    def dim(self) -> int:
        return int(self.points.shape[1])

    @property
    def n_nodes(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def n_partitions(self) -> int:
        return int(self.partition_roots.shape[0])

    def node_children(self, node: int) -> np.ndarray:
        s = self.child_start[node]
        return self.children[s : s + self.child_count[node]]

    def is_leaf(self, node: int) -> bool:
        return self.child_count[node] == 0

    # --- permutation applicators (cluster_node.hpp:99-175) -------------
    def user_to_cluster(self, x: np.ndarray) -> np.ndarray:
        """Reorder a user-numbered vector (axis 0) into cluster numbering."""
        return np.asarray(x)[self.permutation]

    def cluster_to_user(self, x: np.ndarray) -> np.ndarray:
        """Reorder a cluster-numbered vector (axis 0) into user numbering."""
        out = np.empty_like(np.asarray(x))
        out[self.permutation] = x
        return out

    @property
    def inverse_permutation(self) -> np.ndarray:
        inv = np.empty_like(self.permutation)
        inv[self.permutation] = np.arange(self.permutation.shape[0])
        return inv

    def partition_offsets_sizes(self) -> tuple[np.ndarray, np.ndarray]:
        """(offsets, sizes) in cluster numbering, one per partition."""
        return (
            self.offsets[self.partition_roots].copy(),
            self.sizes[self.partition_roots].copy(),
        )

    def leaves_of(self, node: int) -> list[int]:
        out, stack = [], [node]
        while stack:
            n = stack.pop()
            if self.child_count[n] == 0:
                out.append(n)
            else:
                stack.extend(reversed(self.node_children(n).tolist()))
        return out


# ----------------------------------------------------------------------
# direction + splitting policies
# ----------------------------------------------------------------------


def _pca_direction(pts: np.ndarray, w: np.ndarray, center: np.ndarray) -> np.ndarray:
    """Largest eigenvector of the weighted covariance (ComputeLargestExtent,
    partitioning.hpp:159-193)."""
    u = pts - center
    cov = (u * w[:, None]).T @ u
    _, vecs = np.linalg.eigh(cov)
    return vecs[:, -1]


def _bounding_box_direction(pts: np.ndarray) -> np.ndarray:
    """Axis of largest extent (ComputeBoundingBox, partitioning.hpp:195-231)."""
    ext = pts.max(axis=0) - pts.min(axis=0)
    d = np.zeros(pts.shape[1])
    d[int(np.argmax(ext))] = 1.0
    return d


def _regular_splitting(offset: int, size: int, n_parts: int) -> list[tuple[int, int]]:
    """Equal-count split; remainder goes to the last child
    (RegularSplitting, partitioning.hpp:233-250)."""
    child = size // n_parts
    parts = [(offset + child * p, child) for p in range(n_parts - 1)]
    parts.append((offset + child * (n_parts - 1), size - child * (n_parts - 1)))
    return parts


def _geometric_splitting(
    offset: int, size: int, proj_sorted: np.ndarray, n_parts: int
) -> list[tuple[int, int]]:
    """Equal geometric length along the direction
    (GeometricSplitting, partitioning.hpp:252-296)."""
    if size <= n_parts:
        return []
    span = proj_sorted[-1] - proj_sorted[0]
    step = span / n_parts
    bounds = [0]
    first = proj_sorted[0]
    start = 0
    for _ in range(n_parts - 1):
        rel = proj_sorted[start:] - first
        nxt = np.searchsorted(rel > step, True)
        if start + nxt >= size:
            bounds.append(start)
            break
        start = start + int(nxt)
        first = proj_sorted[start]
        bounds.append(start)
    while len(bounds) < n_parts:
        bounds.append(bounds[-1])
    bounds.append(size)
    return [
        (offset + bounds[p], bounds[p + 1] - bounds[p]) for p in range(n_parts)
    ]


# ----------------------------------------------------------------------
# multi-axis partitioning (Partitioning_N, partitioning.hpp:38-157)
# ----------------------------------------------------------------------


def _direction_basis(
    pts: np.ndarray, w: np.ndarray, center: np.ndarray, use_pca: bool
) -> tuple[np.ndarray, np.ndarray]:
    """Full direction basis with per-direction extent weights, sorted by
    decreasing extent.  PCA: eigenvectors of the weighted covariance with
    sqrt-eigenvalue weights; bounding box: coordinate axes with extents."""
    if use_pca:
        u = pts - center
        cov = (u * w[:, None]).T @ u
        vals, vecs = np.linalg.eigh(cov)
        order = np.argsort(vals)[::-1]
        dirs = vecs[:, order].T  # rows = directions
        wts = np.sqrt(np.maximum(vals[order], 0.0))
    else:
        ext = pts.max(axis=0) - pts.min(axis=0)
        order = np.argsort(ext)[::-1]
        dirs = np.eye(pts.shape[1])[order]
        wts = ext[order]
    return dirs, wts


def _integer_decompositions(n: int, d: int) -> list[list[int]]:
    """All ordered non-increasing factorizations of ``n`` into ``d`` factors
    (the reference's backtrack, partitioning.hpp:42-59)."""
    results: list[list[int]] = []

    def backtrack(remaining_n: int, remaining_d: int, start: int, current: list[int]):
        if remaining_d == 1:
            if 1 <= remaining_n <= start:
                results.append(current + [remaining_n])
            return
        for f in range(start, 0, -1):
            if remaining_n % f == 0:
                backtrack(remaining_n // f, remaining_d - 1, f, current + [f])

    backtrack(n, d, n, [])
    return results


def _best_splitting_counts(n_parts: int, dir_weights: np.ndarray) -> list[int]:
    """Pick the factorization of ``n_parts`` over the relevant directions that
    minimizes the aspect-ratio cost max(w_d/f_d)/min(w_d/f_d)
    (partitioning.hpp:64-86)."""
    n_rel = max(1, int(np.sum(dir_weights > 10 * np.finfo(np.float64).eps)))
    decomps = _integer_decompositions(n_parts, n_rel)
    if not decomps:
        return [n_parts]
    best, best_cost = decomps[0], np.inf
    for dec in decomps:
        ratios = dir_weights[: len(dec)] / np.asarray(dec, np.float64)
        cost = ratios.max() / max(ratios.min(), np.finfo(np.float64).tiny)
        if cost < best_cost:
            best_cost = cost
            best = dec
    return best


def _multi_axis_partitioning(
    perm: np.ndarray,
    off: int,
    size: int,
    points: np.ndarray,
    weights: np.ndarray,
    center: np.ndarray,
    n_parts: int,
    use_pca: bool,
    use_regular: bool,
) -> Optional[list[tuple[int, int]]]:
    """Split [off, off+size) into ``n_parts`` along several directions at once
    (Partitioning_N::compute_partitioning, partitioning.hpp:88-157): choose
    per-direction split counts, then recursively sort+split axis by axis.
    Sorts ``perm`` in place; returns offset/size pairs sorted by offset, or
    None if any sub-split fails (caller falls back to single-axis)."""
    idx0 = perm[off : off + size]
    dirs, wts = _direction_basis(points[idx0], weights[idx0], center, use_pca)
    counts = _best_splitting_counts(n_parts, wts)
    ndir = len(counts)

    result: list[tuple[int, int]] = []
    stack: list[tuple[int, int, int]] = [(off, size, 0)]
    while stack:
        o, s, d = stack.pop()
        direction = dirs[d]
        idx = perm[o : o + s]
        proj = points[idx] @ direction
        order = np.argsort(proj, kind="stable")
        perm[o : o + s] = idx[order]
        if use_regular:
            parts = _regular_splitting(o, s, counts[d])
        else:
            parts = _geometric_splitting(o, s, proj[order], counts[d])
        if len(parts) != counts[d] or any(ps <= 0 for _, ps in parts):
            return None
        if d < ndir - 1:
            for p in reversed(parts):
                stack.append((p[0], p[1], d + 1))
        else:
            result.extend(parts)

    if len(result) != n_parts:
        return None
    result.sort(key=lambda t: t[0])
    return result


# ----------------------------------------------------------------------
# builder
# ----------------------------------------------------------------------


@dataclass
class ClusterTreeBuilder:
    """Builds a :class:`ClusterTree` (ClusterTreeBuilder, tree_builder.hpp:22-207).

    ``direction`` in {"pca", "bounding_box"}; ``splitting`` in
    {"regular", "geometric"}.
    """

    max_leaf_size: int = 128
    n_children: int = 2
    direction: str = "pca"
    splitting: str = "regular"
    strategy: str = "single_axis"  # "single_axis" | "multi_axis" (Partitioning_N)
    backend: str = "auto"  # "auto" | "native" | "python"

    def build(
        self,
        points: np.ndarray,
        n_partitions: int = 1,
        partition: Optional[np.ndarray] = None,
        is_partition_local: bool = False,
        radii: Optional[np.ndarray] = None,
        weights: Optional[np.ndarray] = None,
    ) -> ClusterTree:
        points = np.ascontiguousarray(np.asarray(points, dtype=np.float64))
        if points.ndim != 2:
            raise ValueError("points must be [N, dim]")

        if self.backend in ("auto", "native") and self.strategy == "single_axis":
            from ..native import ct_build_native

            out = ct_build_native(
                points, self.max_leaf_size, self.n_children, self.direction, self.splitting,
                n_partitions, partition, is_partition_local, radii, weights,
            )
            if out is not None:
                return ClusterTree(points=points, max_leaf_size=self.max_leaf_size, **out)
            if self.backend == "native":
                raise RuntimeError("native planner unavailable (g++ compile failed)")
        N, dim = points.shape
        radii = (
            np.zeros(N) if radii is None else np.asarray(radii, dtype=np.float64)
        )
        weights = (
            np.ones(N) if weights is None else np.asarray(weights, dtype=np.float64)
        )

        perm = np.arange(N, dtype=np.int64)

        # node storage (python lists during build)
        offs: list[int] = []
        szs: list[int] = []
        deps: list[int] = []
        pars: list[int] = []
        kids: list[list[int]] = []
        ctrs: list[np.ndarray] = []
        rads: list[float] = []
        rks: list[int] = []
        cnts: list[int] = []

        def center_radius(off: int, size: int) -> tuple[np.ndarray, float]:
            idx = perm[off : off + size]
            w = weights[idx]
            c = (points[idx] * w[:, None]).sum(axis=0) / w.sum()
            r = float(
                (np.linalg.norm(points[idx] - c, axis=1) + radii[idx]).max()
            ) if size > 0 else 0.0
            return c, r

        def add_node(off, size, depth, parent, rank, counter) -> int:
            c, r = center_radius(off, size)
            offs.append(off)
            szs.append(size)
            deps.append(depth)
            pars.append(parent)
            kids.append([])
            ctrs.append(c)
            rads.append(r)
            rks.append(rank)
            cnts.append(counter)
            if parent >= 0:
                kids[parent].append(len(offs) - 1)
            return len(offs) - 1

        root = add_node(0, N, 0, -1, -1, 0)

        # --- partition setup (tree_builder.hpp:77-141) ------------------
        partition_type = "simple"
        depth_of_partition = 1
        n_children_on_partition_level = n_partitions
        additional_children_on_last = 0
        stack: list[int] = []
        is_permutation_local = n_partitions == 1

        if partition is not None and is_partition_local:
            # partition = [(offset, size), ...] pairs in user numbering
            partition_type = "given"
            is_permutation_local = True
            pairs = np.asarray(partition).reshape(-1, 2)
            for p in range(n_partitions):
                off, size = int(pairs[p, 0]), int(pairs[p, 1])
                node = add_node(off, size, 1, root, p, p)
                stack.append(node)
        elif partition is not None:
            # partition = rank id per point (user numbering)
            partition_type = "given"
            part = np.asarray(partition, dtype=np.int64)
            cpt = 0
            local = True
            for p in range(n_partitions):
                idx = np.nonzero(part == p)[0]
                perm[cpt : cpt + idx.shape[0]] = idx
                if idx.shape[0] > 0:
                    local = local and bool(np.all(np.diff(idx) == 1))
                node_off, node_size = cpt, int(idx.shape[0])
                cpt += idx.shape[0]
                node = add_node(node_off, node_size, 1, root, p, p)
                stack.append(node)
            is_permutation_local = local
        else:
            if n_partitions == 1:
                # no partition level needed: the root is the partition root
                depth_of_partition = 0
                rks[root] = 0
            elif n_partitions >= self.n_children:
                depth_of_partition = int(
                    np.floor(np.log(n_partitions) / np.log(self.n_children))
                )
                n_children_on_partition_level = self.n_children
                if n_partitions != self.n_children**depth_of_partition:
                    additional_children_on_last = (
                        n_partitions - self.n_children**depth_of_partition
                    )
            stack.append(root)

        # --- recursive build (tree_builder.hpp:143-204) -----------------
        use_pca = self.direction == "pca"
        use_regular = self.splitting == "regular"

        while stack:
            node = stack.pop()
            off, size, depth = offs[node], szs[node], deps[node]
            at_partition_level = (
                partition_type == "simple" and depth == depth_of_partition - 1
            )
            ncur = (
                n_children_on_partition_level
                if at_partition_level
                else self.n_children
            )
            if (
                at_partition_level
                and cnts[node] == self.n_children**depth - 1
                and additional_children_on_last
            ):
                ncur += additional_children_on_last

            parts = None
            if self.strategy == "multi_axis" and ncur > 1:
                parts = _multi_axis_partitioning(
                    perm,
                    off,
                    size,
                    points,
                    weights,
                    ctrs[node],
                    ncur,
                    use_pca,
                    use_regular,
                )
            if parts is None:
                idx = perm[off : off + size]
                pts = points[idx]
                if use_pca:
                    d = _pca_direction(pts, weights[idx], ctrs[node])
                else:
                    d = _bounding_box_direction(pts)
                proj = pts @ d
                order = np.argsort(proj, kind="stable")
                perm[off : off + size] = idx[order]

                if use_regular:
                    parts = _regular_splitting(off, size, ncur)
                else:
                    parts = _geometric_splitting(off, size, proj[order], ncur)

            ok = len(parts) == ncur and all(s > 0 for _, s in parts)
            if not ok:
                continue  # becomes a leaf (partitioning failed)

            for p, (coff, csize) in enumerate(parts):
                rank_of_child = rks[node]
                counter_of_child = cnts[node] * ncur + p
                if at_partition_level:
                    rank_of_child = cnts[node] * n_children_on_partition_level + p
                    counter_of_child = rank_of_child
                child = add_node(
                    coff, csize, depth + 1, node, rank_of_child, counter_of_child
                )
                if csize > self.max_leaf_size:
                    stack.append(child)

        # flatten children lists
        n_nodes = len(offs)
        child_count = np.array([len(k) for k in kids], dtype=np.int64)
        child_start = np.zeros(n_nodes, dtype=np.int64)
        np.cumsum(child_count[:-1], out=child_start[1:])
        children = np.array(
            [c for k in kids for c in k], dtype=np.int64
        ) if n_nodes else np.zeros(0, np.int64)

        ranks_arr = np.array(rks, dtype=np.int64)
        # partition roots: nodes with rank == p at the shallowest depth
        partition_roots = np.zeros(max(n_partitions, 1), dtype=np.int64)
        found: dict[int, int] = {}
        for n in range(n_nodes):
            r = int(ranks_arr[n])
            if r >= 0 and r not in found:
                found[r] = n
        for p in range(n_partitions):
            partition_roots[p] = found[p]

        return ClusterTree(
            points=points,
            permutation=perm,
            offsets=np.array(offs, dtype=np.int64),
            sizes=np.array(szs, dtype=np.int64),
            depths=np.array(deps, dtype=np.int64),
            parents=np.array(pars, dtype=np.int64),
            child_start=child_start,
            child_count=child_count,
            children=children,
            centers=np.array(ctrs),
            radii=np.array(rads),
            ranks=ranks_arr,
            counters=np.array(cnts, dtype=np.int64),
            partition_roots=partition_roots,
            is_permutation_local=is_permutation_local,
            max_leaf_size=self.max_leaf_size,
        )


def build_cluster_tree(points: np.ndarray, **kwargs) -> ClusterTree:
    """Convenience wrapper: ``build_cluster_tree(points, max_leaf_size=...,
    n_partitions=...)``."""
    builder_keys = {"max_leaf_size", "n_children", "direction", "splitting", "strategy"}
    bkw = {k: v for k, v in kwargs.items() if k in builder_keys}
    okw = {k: v for k, v in kwargs.items() if k not in builder_keys}
    return ClusterTreeBuilder(**bkw).build(points, **okw)
