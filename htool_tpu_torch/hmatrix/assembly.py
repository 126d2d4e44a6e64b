"""H-matrix assembly: lower a block-tree plan to the flat bucketed layout.

Port of ``htool_tpu/hmatrix/assembly.py`` (``HMatrixTreeBuilder::build`` +
leaf computation, ``hmatrix/tree_builder/tree_builder.hpp:276-300,568-712``):
leaves are grouped into same-padded-shape buckets and each bucket is
assembled at once — a batched generator gather for dense leaves and the
batched partial ACA of :mod:`.aca` for admissible leaves.  ACA failures
("false positives", tree_builder.hpp:572-577) fall back to dense buckets.

The bucket keys are the reference's: mult32 dense classes, pow2 ACA compute
shapes, mult32 storage classes with one pow2 rank per class.  The JAX
package's compile-count workarounds (``_place_chunk``, ``_class_slice``,
padding every chunk of a pass to one size) become plain indexing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..clustering.cluster_tree import ClusterTree
from ..generator import Generator, TransposedGenerator
from ..utils.device import resolve_device
from ..utils.profiling import span
from .aca import batched_partial_aca
from .compressors import batched_full_aca, batched_recompress, batched_svd_compress
from .block_tree import BlockTreePlan, plan_block_tree
from .hmatrix import DenseBucket, HMatrix, LowRankBucket

__all__ = ["HMatrixBuilder", "build_hmatrix", "assemble_from_plan", "hmatrix_from_dense"]


def _pad_dim(s: int, mode: str = "pow2") -> int:
    """Pad a block dimension: ``mult8`` (next multiple of 8), ``mult32``
    (next multiple of 32, the storage classes) or ``pow2`` (next power of
    two, the ACA compute shapes)."""
    if s <= 8:
        return 8
    if mode == "mult8":
        return int(-(-s // 8) * 8)
    if mode == "mult32":
        return max(32, int(-(-s // 32) * 32))
    p = 8
    while p < s:
        p *= 2
    return p


def _pad_rank(r: int) -> int:
    p = 8
    while p < r:
        p *= 2
    return p


def _assemble_dense_bucket(gen, rows, cols, t_sizes, s_sizes):
    """rows [nb, bm], cols [nb, bn] (user numbering, padded entries clamped).
    Returns data [nb, bm, bn] with padded rows/cols zeroed."""
    data = gen.block(rows, cols)
    bm, bn = rows.shape[1], cols.shape[1]
    dev = data.device
    row_mask = torch.arange(bm, device=dev)[None, :] < t_sizes[:, None]
    col_mask = torch.arange(bn, device=dev)[None, :] < s_sizes[:, None]
    return data.masked_fill_(~(row_mask[:, :, None] & col_mask[:, None, :]), 0)


def _block_indices(perm: np.ndarray, offs: np.ndarray, sizes: np.ndarray, pad: int):
    """User-numbering gather indices for blocks: [nb, pad]; padded entries are
    clamped to the last valid index (their values are masked to zero)."""
    ar = np.arange(pad)[None, :]
    rel = np.minimum(ar, sizes[:, None] - 1)
    return perm[offs[:, None] + rel]


_COMPRESSORS = {
    "partial_aca": batched_partial_aca,
    "sym_partial_aca": batched_partial_aca,  # orientation handled by the caller
    "full_aca": batched_full_aca,
    "svd": batched_svd_compress,
}
_PARTIAL = ("partial_aca", "sym_partial_aca")
# compressors that assemble whole blocks before compressing them
_ASSEMBLING = (batched_full_aca, batched_svd_compress)


def _get_compressor(name):
    """Resolve a compressor: a registry name, or a user-supplied CALLABLE
    with the ``batched_partial_aca`` signature — the
    ``VirtualLowRankGenerator`` hook (virtual_lrmat_generator.hpp:11-56)::

        compressor(generator, rows, cols, t_sizes, s_sizes, epsilon, rmax,
                   reqrank) -> (U [nb,m,rmax], V [nb,rmax,n], rank [nb],
                                failed [nb])
    """
    if callable(name):
        return name
    try:
        return _COMPRESSORS[name]
    except KeyError:
        raise ValueError(
            f"unknown compressor {name!r}; choose from {sorted(_COMPRESSORS)}"
        ) from None


# ---- memory-bounded escalating compression -------------------------------

_ACA_CHUNK_BUDGET = int(2e9)  # bytes of U/V buffers per compression call
_ACA_CAPS = (64, 256)  # escalating rank caps before the full advantage bound

# The partial-ACA stopping test reads an ESTIMATE of the incremental error
# (partialACA.hpp:78), so single blocks can land slightly above the
# requested tolerance; stopping a factor tighter keeps the GLOBAL relative
# Frobenius error (the user contract, test_hmatrix_build.hpp:191) under ε.
_ACA_STOP_FACTOR = 0.5


def _compress_escalating(
    compress, generator, rows, cols, t_szs, s_szs, epsilon, rmax, reqrank
):
    """Run the batched compressor with escalating rank caps and bounded
    buffer memory.

    The advantage bound ``rmax ~ mn/(m+n)`` (partialACA.hpp:84) can be
    hundreds while realized ranks are ~10, and the batched buffers are
    allocated at the cap.  So everything is compressed at a small cap
    first; only blocks that fail escalate to the next cap; the last pass
    runs at the true ``rmax`` so the final failures are genuine dense
    fallbacks.  Each pass is chunked so U/V buffers stay under
    ``_ACA_CHUNK_BUDGET``.

    Returns (U [nb, m, w], V [nb, w, n], rank [nb] np, failed [nb] np) with
    ``w`` the smallest pow2 covering the realized ranks.  A compressor that
    assembles whole blocks (full ACA, SVD) also counts the block and its
    temporaries against the budget; chunking changes no result."""
    device = generator.device
    nb, bm = rows.shape
    bn = cols.shape[1]
    itemsize = torch.empty((), dtype=generator.dtype).element_size()
    assembled = bm * bn * itemsize * 4 if compress in _ASSEMBLING else 0

    if reqrank > 0:
        caps = [rmax]
    else:
        caps = [c for c in _ACA_CAPS if c < rmax] + [rmax]

    rank = np.zeros(nb, np.int64)
    failed = np.ones(nb, bool)
    pending = np.ones(nb, bool)
    results = []  # (dst block ids, src rows in the chunk, U chunk, V chunk)

    def dev(a):
        return torch.as_tensor(a, device=device)

    for cap in caps:
        idx = np.nonzero(pending)[0]
        if idx.size == 0:
            break
        per_block = (bm + bn) * cap * itemsize * 3 + assembled  # U + V + transients
        chunk = max(1, min(int(_ACA_CHUNK_BUDGET // per_block), idx.size))
        for lo in range(0, idx.size, chunk):
            sel = idx[lo : lo + chunk]
            Uc, Vc, rk, fl = compress(
                generator, dev(rows[sel]), dev(cols[sel]), dev(t_szs[sel]),
                dev(s_szs[sel]), epsilon, cap, reqrank,
            )
            rk = rk.cpu().numpy()
            ok = ~fl.cpu().numpy()
            rank[sel[ok]] = rk[ok]
            failed[sel[ok]] = False
            pending[sel[ok]] = False
            if ok.any():
                src = np.nonzero(ok)[0]
                results.append((sel[src], src, Uc, Vc))

    # assemble final buffers at the tight pow2 width
    w = 8
    top = int(rank.max()) if nb else 0
    while w < min(top, rmax):
        w *= 2
    w = min(w, rmax) if rmax >= 1 else 1
    U = torch.zeros((nb, bm, w), dtype=generator.dtype, device=device)
    V = torch.zeros((nb, w, bn), dtype=generator.dtype, device=device)
    for dst, src, Uc, Vc in results:
        cw = min(w, Uc.shape[2])
        dst_t, src_t = dev(dst), dev(src)
        U[dst_t, :, :cw] = Uc[src_t, :, :cw]
        V[dst_t, :cw, :] = Vc[src_t, :cw, :]
    return U, V, rank, failed


def assemble_from_plan(
    plan: BlockTreePlan,
    generator: Generator,
    max_rank: int | None = None,
    reqrank: int = -1,
    compressor="partial_aca",
    recompress: bool = False,
) -> HMatrix:
    """Assemble the flat H-matrix from a planned block tree, on the
    generator's device.

    ``compressor``: "partial_aca" (default), "sym_partial_aca" (partial ACA
    with the offset-oriented pivot walk of the reference's default
    sympartialACA, ``sympartialACA.hpp:48-63``: blocks with
    ``t_off < s_off`` are compressed on the transposed block), "full_aca",
    "svd" (:mod:`.compressors`), or any CALLABLE with the
    ``batched_partial_aca`` signature.

    ``recompress=True`` applies batched SVD recompression to every
    compressed block right after compression, with any compressor — the
    ``RecompressedLowRankGenerator`` decorator
    (recompressed_low_rank_generator.hpp:19-25)."""
    compress = _get_compressor(compressor)
    tt, st = plan.target_tree, plan.source_tree
    perm_t, perm_s = tt.permutation, st.permutation
    device = generator.device
    t0 = time.perf_counter()

    dense_buckets: list[DenseBucket] = []
    lr_buckets: list[LowRankBucket] = []
    n_false_positive = 0
    sym_orient = compressor == "sym_partial_aca"

    def dev(a):
        return torch.as_tensor(a, device=device)

    # ---------------- group leaves by (padded shape, mirror) ----------------
    # dense buckets store at mult32 shapes; admissible buckets compress at
    # pow2 shapes, and storage is re-tightened below
    def group(leaves, mode, orient=False):
        groups: dict[tuple[int, int, bool, bool], list] = {}
        for l in leaves:
            swap = bool(orient and l.t_off < l.s_off)
            key = (_pad_dim(l.t_size, mode), _pad_dim(l.s_size, mode), l.mirror, swap)
            groups.setdefault(key, []).append(l)
        return groups

    dense_groups = group(plan.dense, "mult32")
    adm_groups = group(plan.admissible, "pow2", orient=sym_orient)

    # ---------------- admissible leaves: batched ACA ----------------
    t_aca0 = time.perf_counter()
    with span("htool.assembly.aca"):
        for (bm, bn, mirror, swap), leaves in sorted(adm_groups.items()):
            t_offs = np.array([l.t_off for l in leaves], dtype=np.int64)
            s_offs = np.array([l.s_off for l in leaves], dtype=np.int64)
            t_szs = np.array([l.t_size for l in leaves], dtype=np.int64)
            s_szs = np.array([l.s_size for l in leaves], dtype=np.int64)

            rows = _block_indices(perm_t, t_offs, t_szs, bm)
            cols = _block_indices(perm_s, s_offs, s_szs, bn)

            # advantage bound caps the useful rank (partialACA.hpp:84)
            max_useful = int(np.max((t_szs * s_szs) // (t_szs + s_szs))) + 1
            rmax = min(max_useful, min(bm, bn))
            if max_rank is not None:
                rmax = min(rmax, max_rank)
            if reqrank > 0:
                rmax = min(max(rmax, reqrank), min(bm, bn))
            rmax = max(rmax, 1)

            # estimator-based compressors stop at a tighter internal tolerance
            # so the GLOBAL error honors the user's epsilon
            eps_stop = plan.epsilon * (
                _ACA_STOP_FACTOR if compressor in _PARTIAL else 1.0
            )
            if swap:
                # transposed walk (sympartialACA orientation): compress Aᵀ, then
                # A = (U_B V_B)ᵀ = V_Bᵀ · U_Bᵀ
                U_B, V_B, rank, failed = _compress_escalating(
                    compress, TransposedGenerator(generator), cols, rows,
                    s_szs, t_szs, eps_stop, rmax, reqrank,
                )
                U = V_B.transpose(1, 2)
                V = U_B.transpose(1, 2)
            else:
                U, V, rank, failed = _compress_escalating(
                    compress, generator, rows, cols, t_szs, s_szs, eps_stop,
                    rmax, reqrank,
                )

            if recompress:
                U, V, new_rank = batched_recompress(U, V, dev(rank), plan.epsilon)
                rank = np.where(failed, 0, new_rank.cpu().numpy()).astype(np.int64)

            # --- successful blocks: re-pack into tight storage buckets ---
            # storage classes use mult32 dims and one pow2 rank per class; rows,
            # cols and rank columns beyond the true sizes are exact zeros, so
            # slicing is lossless
            ok = np.nonzero(~failed & (rank > 0))[0]
            if ok.size:
                sclasses: dict[tuple[int, int], list[int]] = {}
                for i in ok:
                    key = (
                        min(bm, _pad_dim(int(t_szs[i]), "mult32")),
                        min(bn, _pad_dim(int(s_szs[i]), "mult32")),
                    )
                    sclasses.setdefault(key, []).append(int(i))
                for (bm8, bn8), idxs in sorted(sclasses.items()):
                    sel = np.array(idxs)
                    rc = min(_pad_rank(int(rank[sel].max())), rmax)
                    sel_t = dev(sel)
                    lr_buckets.append(
                        LowRankBucket(
                            U=U[sel_t, :bm8, :rc].contiguous(),
                            V=V[sel_t, :rc, :bn8].contiguous(),
                            t_off=dev(t_offs[sel]),
                            s_off=dev(s_offs[sel]),
                            t_sizes=t_szs[sel],
                            s_sizes=s_szs[sel],
                            ranks=rank[sel],
                            mirror=mirror,
                        )
                    )

            # --- failed blocks: dense fallback (false positives) ---
            bad = np.nonzero(failed)[0]
            n_false_positive += int(bad.size)
            for i in bad:
                l = leaves[int(i)]
                key = (
                    _pad_dim(l.t_size, "mult32"),
                    _pad_dim(l.s_size, "mult32"),
                    l.mirror,
                    False,
                )
                dense_groups.setdefault(key, []).append(l)
            del U, V
        # the time covers the device's work: the last steps' repacking copies
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    t_aca = time.perf_counter() - t_aca0

    # ---------------- dense leaves: batched generator gather ----------------
    t_dense0 = time.perf_counter()
    for (bm, bn, mirror, _), leaves in sorted(dense_groups.items()):
        if not leaves:
            continue
        t_offs = np.array([l.t_off for l in leaves], dtype=np.int64)
        s_offs = np.array([l.s_off for l in leaves], dtype=np.int64)
        t_szs = np.array([l.t_size for l in leaves], dtype=np.int64)
        s_szs = np.array([l.s_size for l in leaves], dtype=np.int64)
        data = _assemble_dense_bucket(
            generator,
            dev(_block_indices(perm_t, t_offs, t_szs, bm)),
            dev(_block_indices(perm_s, s_offs, s_szs, bn)),
            dev(t_szs),
            dev(s_szs),
        )
        dense_buckets.append(
            DenseBucket(
                data=data,
                t_off=dev(t_offs),
                s_off=dev(s_offs),
                t_sizes=t_szs,
                s_sizes=s_szs,
                mirror=mirror,
            )
        )

    # ---------------- container ----------------
    if plan.target_partition >= 0:
        t_root = int(tt.partition_roots[plan.target_partition])
        t_root_off = int(tt.offsets[t_root])
        m_local = int(tt.sizes[t_root])
    else:
        t_root_off = 0
        m_local = tt.n_points

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    h = HMatrix(
        shape=(m_local, st.n_points),
        dense_buckets=dense_buckets,
        lr_buckets=lr_buckets,
        perm_t=dev(np.asarray(perm_t, np.int64)),
        perm_s=dev(np.asarray(perm_s, np.int64)),
        symmetry=plan.symmetry,
        UPLO=plan.UPLO,
        t_root_off=t_root_off,
        s_root_off=0,
        info={},
    )
    h.info.update(
        epsilon=plan.epsilon,
        eta=plan.eta,
        n_false_positive=n_false_positive,
        n_dense_blocks=sum(b.n_blocks for b in dense_buckets),
        n_low_rank_blocks=sum(b.n_blocks for b in lr_buckets),
        assembly_walltime=time.perf_counter() - t0,
        # phase breakdown: compression (ending at a device sync, the span
        # htool.assembly.aca) vs dense generator evaluation
        aca_walltime=t_aca,
        dense_blocks_walltime=time.perf_counter() - t_dense0,
    )
    return h


class HMatrixBuilder:
    """Convenience builder mirroring ``HMatrixTreeBuilder``
    (tree_builder.hpp:180-264): parameters epsilon, eta, symmetry/UPLO,
    reqrank, min depths, block-tree consistency."""

    def __init__(
        self,
        epsilon: float = 1e-6,
        eta: float = 10.0,
        symmetry: str = "N",
        UPLO: str = "N",
        reqrank: int = -1,
        min_target_depth: int = 0,
        min_source_depth: int = 0,
        max_rank: int | None = None,
        block_tree_consistency: bool = True,
        compressor="partial_aca",
        recompress: bool = False,
        partition_number_for_symmetry: int = -1,
        admissibility=None,
    ):
        self.compressor = compressor
        self.recompress = recompress
        self.partition_number_for_symmetry = partition_number_for_symmetry
        # pluggable VirtualAdmissibilityCondition hook
        # (virtual_admissibility_condition.hpp:17-24); None = RjasanowSteinbach
        self.admissibility = admissibility
        self.epsilon = epsilon
        self.eta = eta
        self.symmetry = symmetry
        self.UPLO = UPLO
        self.reqrank = reqrank
        self.min_target_depth = min_target_depth
        self.min_source_depth = min_source_depth
        self.max_rank = max_rank
        self.block_tree_consistency = block_tree_consistency

    def build(
        self,
        generator: Generator,
        target_tree: ClusterTree,
        source_tree: ClusterTree | None = None,
        target_partition: int = -1,
        source_partition: int = -1,
    ) -> HMatrix:
        t0 = time.perf_counter()
        plan = plan_block_tree(
            target_tree,
            source_tree,
            epsilon=self.epsilon,
            eta=self.eta,
            symmetry=self.symmetry,
            UPLO=self.UPLO,
            target_partition=target_partition,
            min_target_depth=self.min_target_depth,
            min_source_depth=self.min_source_depth,
            block_tree_consistency=self.block_tree_consistency,
            partition_number_for_symmetry=self.partition_number_for_symmetry,
            source_partition=source_partition,
            admissibility=self.admissibility,
        )
        plan_time = time.perf_counter() - t0
        h = assemble_from_plan(
            plan,
            generator,
            max_rank=self.max_rank,
            reqrank=self.reqrank,
            compressor=self.compressor,
            recompress=self.recompress,
        )
        h.info["block_tree_walltime"] = plan_time
        return h


def build_hmatrix(
    generator: Generator,
    target_tree: ClusterTree,
    source_tree: ClusterTree | None = None,
    epsilon: float = 1e-6,
    eta: float = 10.0,
    symmetry: str = "N",
    UPLO: str = "N",
    **kwargs,
) -> HMatrix:
    """One-shot: plan + assemble (the ``HMatrixBuilder::build`` entry point)."""
    target_partition = kwargs.pop("target_partition", -1)
    return HMatrixBuilder(
        epsilon=epsilon, eta=eta, symmetry=symmetry, UPLO=UPLO, **kwargs
    ).build(generator, target_tree, source_tree, target_partition=target_partition)


def hmatrix_from_dense(
    A,
    tree: ClusterTree,
    target_partition: int = -1,
    source_partition: int = -1,
    device=None,
) -> HMatrix:
    """Wrap a DENSE (sub)matrix as a single-bucket HMatrix — the dense
    local-operator of the distributed layer
    (``implementations/global_to_local_operators/dense_matrix.hpp:9-45``).

    ``A`` is in CLUSTER numbering and spans the (partition-restricted)
    target/source ranges of ``tree``.  It lives on ``device`` (default: A's
    own when it is a tensor, else the GPU; see :mod:`..utils.device`)."""
    A = torch.as_tensor(A, device=resolve_device(device, A))
    offs, sizes = tree.partition_offsets_sizes()
    t_off = int(offs[target_partition]) if target_partition >= 0 else 0
    t_size = int(sizes[target_partition]) if target_partition >= 0 else tree.n_points
    s_off = int(offs[source_partition]) if source_partition >= 0 else 0
    s_size = int(sizes[source_partition]) if source_partition >= 0 else tree.n_points
    if tuple(A.shape) != (t_size, s_size):
        raise ValueError(
            f"dense block has shape {tuple(A.shape)}, expected ({t_size}, {s_size})"
        )
    bm = max(8, -(-t_size // 8) * 8)
    bn = max(8, -(-s_size // 8) * 8)
    data = torch.zeros((1, bm, bn), dtype=A.dtype, device=A.device)
    data[0, :t_size, :s_size] = A
    bucket = DenseBucket(
        data=data,
        t_off=torch.tensor([t_off], dtype=torch.int64, device=A.device),
        s_off=torch.tensor([s_off], dtype=torch.int64, device=A.device),
        t_sizes=np.array([t_size]),
        s_sizes=np.array([s_size]),
    )
    perm = torch.as_tensor(np.asarray(tree.permutation), dtype=torch.int64, device=A.device)
    return HMatrix(
        shape=(t_size, tree.n_points),
        dense_buckets=[bucket],
        lr_buckets=[],
        perm_t=perm,
        perm_s=perm,
        t_root_off=t_off,
        info=dict(epsilon=0.0, eta=0.0, n_false_positive=0,
                  n_dense_blocks=1, n_low_rank_blocks=0),
    )
