"""Block-tree planner — host-side, produces a flat leaf list.

A copy of ``htool_tpu/hmatrix/block_tree.py`` (the port imports no JAX, so
host planners are copied).  ``backend="auto"`` (the default) runs the C++
planner of :mod:`htool_tpu_torch.native` and falls back to the python
recursion below when it does not build.

The reference builds a pointer tree of HMatrix nodes
(``hmatrix/tree_builder/tree_builder.hpp:417-531``); here the same recursion
runs once on host over the cluster-tree arrays and emits only the **leaves**
(dense blocks and admissible/low-rank candidates) as flat offset/size tables.
The hierarchical structure is never materialized on device.

Behavioral parity notes:
- admissibility: RjasanowSteinbach ``2·min(r_t,r_s) < η·max(dist−r_t−r_s, 0)``
  (``hmatrix/interfaces/virtual_admissibility_condition.hpp:20-23``)
- recursion cases incl. symmetry pruning, target-partition restriction, and
  consistent/inconsistent splitting (``tree_builder.hpp:437-531``,
  ``is_removed_by_symmetry:95-111``)
- admissible blocks additionally require min target/source depth and
  ``t.rank >= 0`` (``tree_builder.hpp:437``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..clustering.cluster_tree import ClusterTree

__all__ = ["BlockTreePlan", "plan_block_tree", "rjasanow_steinbach"]


def rjasanow_steinbach(
    tc: np.ndarray, tr: float, sc: np.ndarray, sr: float, eta: float
) -> bool:
    """RjasanowSteinbach admissibility (virtual_admissibility_condition.hpp:21)."""
    dist = float(np.linalg.norm(tc - sc))
    return 2.0 * min(tr, sr) < eta * max(dist - tr - sr, 0.0)


@dataclass
class BlockLeaf:
    t_node: int
    s_node: int
    t_off: int
    t_size: int
    s_off: int
    s_size: int
    # True for stored off-diagonal leaves of a symmetric matrix whose mirrored
    # (transposed/conjugated) contribution must be added in products
    # (get_leaves_from leaves_for_symmetry, hmatrix.hpp:248-274)
    mirror: bool = False


@dataclass
class BlockTreePlan:
    target_tree: ClusterTree
    source_tree: ClusterTree
    dense: list[BlockLeaf] = field(default_factory=list)
    admissible: list[BlockLeaf] = field(default_factory=list)
    epsilon: float = 1e-6
    eta: float = 10.0
    symmetry: str = "N"
    UPLO: str = "N"
    target_partition: int = -1  # -1 = global block tree
    block_tree_consistency: bool = True

    @property
    def shape(self) -> tuple[int, int]:
        return (self.target_tree.n_points, self.source_tree.n_points)

    def leaf_arrays(self, kind: str) -> np.ndarray:
        """[n_leaves, 5] int array (t_off, t_size, s_off, s_size, mirror)."""
        leaves = self.dense if kind == "dense" else self.admissible
        if not leaves:
            return np.zeros((0, 5), dtype=np.int64)
        return np.array(
            [[l.t_off, l.t_size, l.s_off, l.s_size, int(l.mirror)] for l in leaves],
            dtype=np.int64,
        )


def plan_block_tree(
    target_tree: ClusterTree,
    source_tree: ClusterTree | None = None,
    epsilon: float = 1e-6,
    eta: float = 10.0,
    symmetry: str = "N",
    UPLO: str = "N",
    target_partition: int = -1,
    min_target_depth: int = 0,
    min_source_depth: int = 0,
    block_tree_consistency: bool = True,
    leaf_level: int | None = None,
    backend: str = "auto",
    partition_number_for_symmetry: int = -1,
    source_partition: int = -1,
    admissibility=None,
) -> BlockTreePlan:
    """Plan the admissibility-pruned block tree (tree_builder.hpp:417-531).

    ``leaf_level``: treat cluster nodes at this depth as leaves, producing a
    uniform-grid (BLR-style) plan where every leaf is a depth-``leaf_level``
    cell pair; implies min depths >= leaf_level.

    ``admissibility``: pluggable condition — the
    ``VirtualAdmissibilityCondition`` hook
    (``hmatrix/interfaces/virtual_admissibility_condition.hpp:17-24``).  A
    callable ``(t_center, t_radius, s_center, s_radius, eta) -> bool`` with
    the :func:`rjasanow_steinbach` signature; ``None`` uses
    RjasanowSteinbach (the reference default).  Custom conditions run
    through the host python recursion (the native planner only evaluates
    the built-in condition).

    ``source_partition`` (with ``target_partition``) restricts the plan to
    the (target, source) partition block — the recursion starts at the two
    partition roots, yielding the diagonal-pair H-matrix of the reference's
    ``DefaultLocalApproximationBuilder`` (distributed_operator/utility.hpp:
    63-88) when both equal the device's partition."""
    if source_tree is None:
        source_tree = target_tree
    if leaf_level is not None:
        min_target_depth = max(min_target_depth, leaf_level)
        min_source_depth = max(min_source_depth, leaf_level)
    if symmetry not in ("N", "S", "H"):
        raise ValueError(f"invalid symmetry {symmetry!r}")
    if (symmetry == "N") != (UPLO == "N"):
        raise ValueError("symmetry 'N' requires UPLO 'N' and vice versa")
    if symmetry != "N" and UPLO not in ("L", "U"):
        raise ValueError(f"invalid UPLO {UPLO!r}")
    if symmetry != "N" and source_tree is not None and source_tree is not target_tree:
        raise ValueError(
            "symmetric/hermitian block trees require target and source to be "
            "the same cluster tree"
        )

    tt, st = target_tree, source_tree
    plan = BlockTreePlan(
        target_tree=tt,
        source_tree=st,
        epsilon=epsilon,
        eta=eta,
        symmetry=symmetry,
        UPLO=UPLO,
        target_partition=target_partition,
        block_tree_consistency=block_tree_consistency,
    )

    def in_target_partition(t: int) -> bool:
        return target_partition == -1 or tt.ranks[t] == target_partition

    pns = partition_number_for_symmetry
    if pns >= 0:
        pns_t = int(tt.partition_roots[pns])
        pns_s = int(st.partition_roots[pns])
        pns_t_off, pns_t_end = int(tt.offsets[pns_t]), int(
            tt.offsets[pns_t] + tt.sizes[pns_t]
        )
        pns_s_off, pns_s_end = int(st.offsets[pns_s]), int(
            st.offsets[pns_s] + st.sizes[pns_s]
        )

    def in_pns_diag(t: int, s: int) -> bool:
        """Block lies in the symmetric region: globally for pns == -1, else
        inside the pns diagonal partition block (tree_builder.hpp:95-111)."""
        if pns < 0:
            return True
        return (
            pns_t_off <= tt.offsets[t]
            and tt.offsets[t] + tt.sizes[t] <= pns_t_end
            and pns_s_off <= st.offsets[s]
            and st.offsets[s] + st.sizes[s] <= pns_s_end
        )

    def removed_by_symmetry(t: int, s: int) -> bool:
        # symmetry pruning, optionally restricted to the pns diagonal
        # partition block (tree_builder.hpp:95-111)
        if symmetry == "N":
            return False
        if UPLO == "U":
            return tt.offsets[t] >= st.offsets[s] + st.sizes[s] and in_pns_diag(t, s)
        return st.offsets[s] >= tt.offsets[t] + tt.sizes[t] and in_pns_diag(t, s)

    def partition_roots_within(tree: ClusterTree, node: int):
        off, size = tree.offsets[node], tree.sizes[node]
        return [
            int(p)
            for p in tree.partition_roots
            if off <= tree.offsets[p]
            and tree.offsets[p] + tree.sizes[p] <= off + size
        ]

    def make_leaf(t: int, s: int) -> BlockLeaf:
        return BlockLeaf(
            t_node=t,
            s_node=s,
            t_off=int(tt.offsets[t]),
            t_size=int(tt.sizes[t]),
            s_off=int(st.offsets[s]),
            s_size=int(st.sizes[s]),
            # mirrored contribution needed only for off-diagonal leaves in
            # the symmetric region (whose transposed counterpart was pruned)
            mirror=(
                symmetry != "N"
                and int(tt.offsets[t]) != int(st.offsets[s])
                and in_pns_diag(t, s)
            ),
        )

    if source_partition >= 0:
        # partition-pair restriction runs the python recursion from the
        # partition roots; these plans are small by construction
        backend = "python"
    if admissibility is not None:
        if backend == "native":
            raise ValueError(
                "custom admissibility conditions require the python planner "
                "(backend='auto' or 'python')"
            )
        backend = "python"
    else:
        admissibility = rjasanow_steinbach

    if backend in ("auto", "native"):
        from ..native import bt_plan_native

        res = bt_plan_native(
            tt, st, eta, symmetry, UPLO, target_partition, min_target_depth,
            min_source_depth, block_tree_consistency, leaf_level,
            partition_number_for_symmetry,
        )
        if res is not None:
            plan.dense, plan.admissible = (
                [BlockLeaf(*map(int, r[:6]), bool(r[6])) for r in rows] for rows in res
            )
            return plan
        if backend == "native":
            raise RuntimeError("native planner unavailable (g++ compile failed)")

    def t_is_leaf(t):
        return tt.is_leaf(t) or (leaf_level is not None and tt.depths[t] >= leaf_level)

    def s_is_leaf(s):
        return st.is_leaf(s) or (leaf_level is not None and st.depths[s] >= leaf_level)

    if source_partition >= 0:
        t0_node = int(tt.partition_roots[target_partition]) if target_partition >= 0 else 0
        s0_node = int(st.partition_roots[source_partition])
        stack: list[tuple[int, int]] = [(t0_node, s0_node)]
    else:
        stack = [(0, 0)]
    while stack:
        t, s = stack.pop()
        t_leaf = t_is_leaf(t)
        s_leaf = s_is_leaf(s)
        admissible = admissibility(
            tt.centers[t], tt.radii[t], st.centers[s], st.radii[s], eta
        )

        if (
            admissible
            and in_target_partition(t)
            and not removed_by_symmetry(t, s)
            and tt.depths[t] >= min_target_depth
            and st.depths[s] >= min_source_depth
            and tt.ranks[t] >= 0
            and (not block_tree_consistency or st.ranks[s] >= 0)
        ):
            plan.admissible.append(make_leaf(t, s))
        elif s_leaf and t_leaf:
            plan.dense.append(make_leaf(t, s))
        elif s_leaf and not t_leaf:
            for tc in tt.node_children(t):
                if (in_target_partition(tc) or tt.ranks[tc] < 0) and not removed_by_symmetry(tc, s):
                    stack.append((int(tc), s))
        elif t_leaf and not s_leaf:
            for sc in st.node_children(s):
                if not removed_by_symmetry(t, int(sc)):
                    stack.append((t, int(sc)))
        elif block_tree_consistency:
            if tt.ranks[t] < 0 and st.ranks[s] >= 0:
                for tc in partition_roots_within(tt, t):
                    if (in_target_partition(tc) or tt.ranks[tc] < 0) and not removed_by_symmetry(tc, s):
                        stack.append((tc, s))
            elif st.ranks[s] < 0 and tt.ranks[t] >= 0:
                for sc in partition_roots_within(st, s):
                    if not removed_by_symmetry(t, sc):
                        stack.append((t, sc))
            else:
                for tc in tt.node_children(t):
                    for sc in st.node_children(s):
                        if (in_target_partition(int(tc)) or tt.ranks[tc] < 0) and not removed_by_symmetry(int(tc), int(sc)):
                            stack.append((int(tc), int(sc)))
        else:
            # inconsistent block tree: split the larger side (tree_builder.hpp:490-529)
            if tt.ranks[t] < 0:
                for tc in partition_roots_within(tt, t):
                    if (in_target_partition(tc) or tt.ranks[tc] < 0) and not removed_by_symmetry(tc, s):
                        stack.append((tc, s))
            elif st.sizes[s] > tt.sizes[t]:
                for sc in st.node_children(s):
                    if (in_target_partition(t) or tt.ranks[t] < 0) and not removed_by_symmetry(t, int(sc)):
                        stack.append((t, int(sc)))
            elif tt.sizes[t] > st.sizes[s]:
                for tc in tt.node_children(t):
                    if (in_target_partition(int(tc)) or tt.ranks[tc] < 0) and not removed_by_symmetry(int(tc), s):
                        stack.append((int(tc), s))
            else:
                for tc in tt.node_children(t):
                    for sc in st.node_children(s):
                        if (in_target_partition(int(tc)) or tt.ranks[tc] < 0) and not removed_by_symmetry(int(tc), int(sc)):
                            stack.append((int(tc), int(sc)))

    return plan
