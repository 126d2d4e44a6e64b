"""GenEO two-level coarse space.

Port of ``htool_tpu/solvers/geneo.py``, which mirrors the reference's GenEO
builders (``solvers/geneo/coarse_space_builder.hpp:15-185`` and
``coarse_operator_builder.hpp:18-144``):

- per subdomain, solve the generalized EVP ``(D Aᵢ D) v = λ Bᵢ v`` where D is
  the 1/0 interior partition of unity (DAiD = Aᵢ with only the interior block
  kept, coarse_space_builder.hpp:28-37), Bᵢ a user-supplied local matrix
  (Neumann matrix in the BEM/FEM setting; defaults to Aᵢ);
- select the ν eigenvectors of largest |λ| (or all with |λ| > threshold)
  (coarse_space_builder.hpp:102-107);
- coarse basis Z keeps only interior rows (Z = D·v, :127-133);
- coarse operator E = Z* A Z assembled with global products
  (coarse_operator_builder.hpp:80-128) and LU-factorized.

Two-level corrections (HPDDM ``-hpddm_schwarz_coarse_correction``):
additive, deflated, balanced.

Symmetric and hermitian EVPs run batched on the device (Cholesky,
triangular solves, ``torch.linalg.eigh``); the general EVP runs per
subdomain on the host (``scipy.linalg.eig``).  E, its LU and the corrections
live on the device of the generator.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..clustering.cluster_tree import ClusterTree
from ..generator import Generator
from ..utils.profiling import Timer

__all__ = ["GeneoCoarseSpace", "build_geneo_coarse_space"]


@dataclass
class GeneoCoarseSpace:
    Z: Any  # [N, nc] global coarse basis, cluster numbering (replicated
    # store) — None for the local store, which keeps only Z_loc
    E_lu: Any
    E_piv: Any
    size: int
    nu_per_subdomain: np.ndarray = None
    eigenvalues: list = None
    # local store (store='local'): per-partition interior-supported
    # columns.  Z column (p, j) lives at rows [row_off[p], row_off[p]+sz_p)
    # and coarse index p*nu_max + j; nothing [N, nc]-sized is ever built
    # (the reference assembles E the same way — per-rank Z blocks +
    # sub-products, coarse_operator_builder.hpp:18-129).
    Z_loc: Any = None  # [P, sz_max, nu_max]
    row_off: np.ndarray = None  # [P]
    row_size: np.ndarray = None  # [P]
    nu_max: int = 0

    def _rows(self):
        """Cluster rows of the local store's slots [P, sz_max] (clamped into
        range on padding) and the mask of the real ones."""
        if getattr(self, "_rows_cache", None) is None:
            dev = self.Z_loc.device
            ar = np.arange(self.Z_loc.shape[1])[None, :]
            n = int(self.row_size.sum())
            rows = np.minimum(self.row_off[:, None] + ar, n - 1)
            self._rows_cache = (torch.as_tensor(rows, device=dev),
                                torch.as_tensor(ar < self.row_size[:, None], device=dev))
        return self._rows_cache

    def _zt_apply(self, r):
        """Z* r from the local store: [N, k] -> [P * nu_max, k]."""
        rows, mask = self._rows()
        rs = r[rows].masked_fill(~mask[:, :, None], 0)  # [P, sz_max, k]
        mu = torch.einsum("psn,psk->pnk", self.Z_loc.to(r.dtype).conj(), rs)
        return mu.reshape(-1, r.shape[1])

    def _z_apply(self, c):
        """Z c from the local store: [P * nu_max, k] -> [N, k]."""
        P, sz_max, _ = self.Z_loc.shape
        rows, mask = self._rows()
        k = c.shape[1]
        zs = torch.einsum("psn,pnk->psk", self.Z_loc.to(c.dtype), c.reshape(P, self.nu_max, k))
        zs = zs.masked_fill(~mask[:, :, None], 0)
        out = torch.zeros((int(self.row_size.sum()), k), dtype=zs.dtype, device=zs.device)
        return out.index_add_(0, rows.reshape(-1), zs.reshape(P * sz_max, k))

    def coarse_solve(self, r):
        """Q r = Z E⁻¹ Z* r for r [N, k] (or [N]), in the dtype that r and
        the basis promote to."""
        squeeze = r.ndim == 1
        if squeeze:
            r = r[:, None]
        basis = self.Z if self.Z is not None else self.Z_loc
        r = r.to(torch.promote_types(r.dtype, basis.dtype))
        lu = self.E_lu.to(r.dtype)
        if self.Z is not None:
            Z = self.Z.to(r.dtype)
            out = Z @ torch.linalg.lu_solve(lu, self.E_piv, Z.mH @ r)
        else:
            out = self._z_apply(torch.linalg.lu_solve(lu, self.E_piv, self._zt_apply(r)))
        return out[:, 0] if squeeze else out

    def combined_preconditioner(
        self,
        one_level: Optional[Callable],
        A_apply: Callable,
        correction: str = "additive",
    ) -> Callable:
        M1 = one_level if one_level is not None else (lambda v: v)
        Q = self.coarse_solve

        if correction == "additive":

            def M(r):
                return M1(r) + Q(r)

        elif correction == "deflated":

            def M(r):
                Qr = Q(r)
                return Qr + M1(r - A_apply(Qr))

        elif correction == "balanced":

            def M(r):
                Qr = Q(r)
                t = M1(r - A_apply(Qr))
                return Qr + t - Q(A_apply(t))

        else:
            raise ValueError(f"unknown coarse correction {correction!r}")

        return M


def _geneo_eigh(DAiD, Bi, subdomains):
    """Batched hermitian-definite generalized EVP over padded subdomains:
    Cholesky-transform Bᵢ = Lᵢ Lᵢᴴ, solve the standard EVP on
    Cᵢ = Lᵢ⁻¹ (D Aᵢ D) Lᵢ⁻ᴴ with one batched ``eigh``, and back-transform
    vᵢ = Lᵢ⁻ᴴ yᵢ — the sygv/hegv reduction (coarse_space_builder.hpp:89-92).
    Raises, naming the subdomain, where a Bᵢ is not positive definite."""
    L, info = torch.linalg.cholesky_ex(Bi)
    bad = torch.nonzero(info).flatten().tolist()
    if bad:
        raise RuntimeError(
            f"GenEO: B_i of subdomain {subdomains[bad[0]]} is not positive definite "
            f"(Cholesky failed at order {int(info[bad[0]])}, {Bi.dtype})")
    C1 = torch.linalg.solve_triangular(L, DAiD, upper=False)
    C = torch.linalg.solve_triangular(L, C1.mH, upper=False).mH
    C = 0.5 * (C + C.mH)
    w, y = torch.linalg.eigh(C)
    v = torch.linalg.solve_triangular(L.mH, y, upper=True)
    return w, v


def build_geneo_coarse_space(
    generator: Generator,
    tree: ClusterTree,
    overlap: list[np.ndarray],
    A_apply: Callable,
    nu: int = 2,
    threshold: float = -1.0,
    local_B: Optional[list[np.ndarray]] = None,
    symmetry: str = "S",
    infos: Optional[dict] = None,
    store: str = "replicated",
    evp_budget_bytes: float = 2e9,
) -> GeneoCoarseSpace:
    """Build the GenEO coarse space on the generator's device.

    ``overlap``: per-partition overlap-only index sets (cluster numbering),
    as produced by :func:`~htool_tpu_torch.solvers.ddm.build_geometric_overlap`.
    ``A_apply``: global operator on cluster-numbered [N, k] tensors (used for
    E = Z* A Z).  ``local_B[p]``: the Bᵢ matrix over [interior; overlap]
    DOFs; defaults to Aᵢ itself.

    Symmetric/hermitian problems run batched device EVPs over padded
    subdomains (:func:`_geneo_eigh`), in chunks of subdomains whose
    [chunk, n_max, n_max] workspace stays under ``evp_budget_bytes``; the
    general path runs host scipy ``eig`` per subdomain (``ggev``,
    coarse_space_builder.hpp:142-145).  ``infos`` (optional dict) receives
    the reference's GenEO entries (ddm.hpp:232-324).

    ``store='replicated'`` keeps the classic [N, nc] basis.
    ``store='local'`` never builds an [N, nc] array: the basis is kept as
    per-partition interior-supported column blocks
    ``Z_loc [P, sz_max, nu_max]`` and E = Z* A Z is assembled per chunk of
    at most 64 partitions with global products on [N, chunk * nu_max]
    blocks (the reference's distributed E assembly,
    ``coarse_operator_builder.hpp:18-129``)."""
    offs, sizes = tree.partition_offsets_sizes()
    P = tree.n_partitions
    N = tree.n_points
    perm = tree.permutation
    device = generator.device
    times: dict = {}
    timer = Timer(times)

    if store not in ("replicated", "local"):
        raise ValueError("store must be 'replicated' or 'local'")

    t0 = time.perf_counter()
    sub_idx = [
        np.concatenate([np.arange(int(offs[p]), int(offs[p] + sizes[p])),
                        np.asarray(overlap[p], np.int64)])
        for p in range(P)
    ]
    n_max = max(i.size for i in sub_idx)

    # per-subdomain selected eigenvectors on the device: [sz_p, nevi]
    vecs: list = [None] * P
    nus = [0] * P
    eigs = [None] * P

    def select(p, w, v, n_i, sz):
        order = np.argsort(-np.abs(w))
        if threshold > 0:
            nevi = int(np.sum(np.abs(w) > threshold))
        else:
            nevi = min(nu, n_i)
        sel = order[:nevi]
        eigs[p] = np.abs(w[sel])
        nus[p] = nevi
        vecs[p] = torch.as_tensor(v[:sz][:, sel], device=device)  # interior rows only

    with timer.phase("GenEO_geev", sync=device):
        if symmetry in ("S", "H"):
            itemsize = torch.empty((), dtype=generator.dtype).element_size()
            per_sub = n_max * n_max * itemsize * 8  # Ai+Bi+EVP transients
            chunk = max(1, min(int(evp_budget_bytes // per_sub), P))
            for lo in range(0, P, chunk):
                ps = list(range(lo, min(lo + chunk, P)))
                c = len(ps)
                rows = np.zeros((c, n_max), np.int64)
                valid = np.zeros((c, n_max), bool)
                for ci, p in enumerate(ps):
                    rows[ci, : sub_idx[p].size] = perm[sub_idx[p]]
                    valid[ci, : sub_idx[p].size] = True
                rows_d = torch.as_tensor(rows, device=device)
                Ai = generator.block(rows_d, rows_d)
                vm = torch.as_tensor(valid, device=device)
                pair = vm[:, :, None] & vm[:, None, :]
                Ai = Ai.masked_fill(~pair, 0)
                if local_B is not None:
                    Bi = torch.zeros((c, n_max, n_max),
                                     dtype=torch.as_tensor(local_B[ps[0]]).dtype, device=device)
                    for ci, p in enumerate(ps):
                        Bp = torch.as_tensor(local_B[p], device=device)
                        Bi[ci, : Bp.shape[0], : Bp.shape[1]] = Bp
                    Bi = Bi.masked_fill(~pair, 0)
                    dt = torch.promote_types(Ai.dtype, Bi.dtype)
                    Ai, Bi = Ai.to(dt), Bi.to(dt)
                else:
                    Bi = Ai
                # identity on padding keeps Bᵢ positive definite
                Bi = Bi + torch.diag_embed((~vm).to(Bi.dtype))
                # DAiD: interior block only (coarse_space_builder.hpp:28-37)
                im = torch.as_tensor(np.arange(n_max)[None, :] < sizes[ps][:, None],
                                     device=device)
                DAiD = Ai.masked_fill(~(im[:, :, None] & im[:, None, :]), 0)
                w_all, v_all = _geneo_eigh(DAiD, Bi, ps)
                w_all = w_all.cpu().numpy()  # [c, n_max] ascending (real)
                for ci, p in enumerate(ps):
                    select(p, w_all[ci], v_all[ci], sub_idx[p].size, int(sizes[p]))
                del Ai, Bi, DAiD, v_all
        else:
            # general (non-hermitian) host path
            import scipy.linalg as sla

            for p in range(P):
                sz = int(sizes[p])
                rows_user = torch.as_tensor(perm[sub_idx[p]], device=device)
                Ai = generator.block(rows_user, rows_user).cpu().numpy()
                DAiD = np.zeros_like(Ai)
                DAiD[:sz, :sz] = Ai[:sz, :sz]
                Bi = np.asarray(local_B[p]) if local_B is not None else Ai
                w, v = sla.eig(DAiD, Bi)
                select(p, w, v, sub_idx[p].size, sz)

    dtype = vecs[0].dtype if P else generator.dtype
    nc = int(sum(nus))
    if store == "local":
        # ---- local store: Z_loc [P, sz_max, nu_max], E per partition chunk ----
        nu_max = max(nus) if nus else 0
        Z_loc = torch.zeros((P, int(sizes.max()), nu_max), dtype=dtype, device=device)
        for p in range(P):
            Z_loc[p, : vecs[p].shape[0], : nus[p]] = vecs[p]
        nc_pad = P * nu_max
        cs = GeneoCoarseSpace(
            Z=None, E_lu=None, E_piv=None, size=nc,
            nu_per_subdomain=np.array(nus), eigenvalues=eigs,
            Z_loc=Z_loc, row_off=np.asarray(offs, np.int64),
            row_size=np.asarray(sizes, np.int64), nu_max=nu_max,
        )
        with timer.phase("GenEO_ZtAZ", sync=device):
            E = torch.zeros((nc_pad, nc_pad), dtype=dtype, device=device)
            # E = Z* A Z per partition chunk: the [N, c*nu_max] transient is
            # the only N-sized buffer (coarse_operator_builder.hpp:80-128)
            eyec = torch.eye(nc_pad, dtype=dtype, device=device)
            qchunk = max(1, min(64, P))
            for lo in range(0, P, qchunk):
                qs = np.arange(lo, min(lo + qchunk, P))
                sel_cols = torch.as_tensor(
                    (qs[:, None] * nu_max + np.arange(nu_max)[None, :]).reshape(-1),
                    device=device)
                AZ = A_apply(cs._z_apply(eyec[:, sel_cols]))  # [N, c*nu_max]
                E[:, sel_cols] = cs._zt_apply(AZ.to(dtype))
            # identity on padded (empty) coarse slots keeps E invertible
            used = np.arange(nc_pad) % max(nu_max, 1) < np.repeat(np.array(nus), nu_max)
            E.diagonal().add_(torch.as_tensor(~used, device=device).to(dtype))
    else:
        Z = torch.zeros((N, nc), dtype=dtype, device=device)
        col = 0
        for p in range(P):
            Z[int(offs[p]) : int(offs[p] + sizes[p]), col : col + nus[p]] = vecs[p]
            col += nus[p]
        cs = GeneoCoarseSpace(Z=Z, E_lu=None, E_piv=None, size=nc,
                              nu_per_subdomain=np.array(nus), eigenvalues=eigs)
        # E = Z* A Z via global products (coarse_operator_builder.hpp:80-128)
        with timer.phase("GenEO_ZtAZ", sync=device):
            E = Z.mH @ A_apply(Z).to(dtype)
    with timer.phase("GenEO_facto_coarse_operator", sync=device):
        cs.E_lu, cs.E_piv = torch.linalg.lu_factor(E)
    cs.build_walltime = time.perf_counter() - t0
    if infos is not None:
        # the reference's GenEO timing infos (ddm.hpp:232-324)
        infos["GenEO_coarse_space_size"] = nc
        infos.update(times)
    return cs
