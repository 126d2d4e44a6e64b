"""Krylov solvers — CG, restarted GMRES and block GMRES with preconditioning.

Port of ``htool_tpu/solvers/krylov.py`` (the role of HPDDM's Krylov loop,
``solvers/ddm.hpp:193``).  The ``lax.while_loop`` iterations become Python
loops over tensors that read their stopping tests on the host (``_read``:
each read is counted in ``syncs`` and spanned as ``htool.krylov.wait``;
each iteration is a ``htool.krylov.step`` span, which ends with the next
iteration's stopping test); the arithmetic is the reference's: per-column
step sizes over multiple right-hand sides, left preconditioning, modified
Gram-Schmidt, the same Givens convention, the preconditioned stopping test
and a true final residual; for block GMRES the blocked Gram-Schmidt, a
Gram-based QR that deflates columns a block has lost (``_block_qr``; the
reference's shifted Cholesky breaks down there) and the least-squares
residual per step, each spanned (``htool.krylov.orth``, ``htool.krylov.lstsq``).
The reference's ``axis_name`` hook is ``mesh=``: under a
:class:`..parallel.collectives.Mesh` the vectors are the per-partition
slices ``[P_local·m, k]`` of the distributed solver, and every dot product
sums over each slice and then over the partitions through ``psum`` (the
MPI_Allreduce of HPDDM's Krylov loop).  CG's arithmetic is written once, as
in-place updates of its state (``_cg_body``); :class:`..ddm.DDMSolver` may
hand ``cg`` a :class:`CGGraphs`, and the step is then replayed from CUDA
graphs captured from that body, the stopping test still read once a step.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..utils.profiling import add_tallies, count, span, tallies

__all__ = ["cg", "gmres", "block_gmres", "KrylovResult"]


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: float  # final relative residual, max over RHS columns
    converged: bool


def _vdot_cols(a, b):
    """Per-column <a, b> with conjugation: [n, k] x [n, k] -> [k]."""
    return torch.sum(a.conj() * b, dim=0)


def _norm_cols(a):
    return torch.sqrt(_vdot_cols(a, a).abs().real)


def _dots(mesh):
    """(vdot, norm, gram) over columns: plain, or, with ``mesh``, over
    per-partition slices [P_local·m, ·] summed per slice and then over the
    partitions (``psum``).  ``gram(a, b)`` is aᴴ b."""
    if mesh is None:
        return _vdot_cols, _norm_cols, lambda a, b: a.mH @ b
    from ..parallel.collectives import psum

    def part(a):
        return a.reshape(mesh.n_local, -1, a.shape[-1])

    def vdot(a, b):
        return psum(torch.sum(part(a).conj() * part(b), dim=1), mesh)

    def gram(a, b):
        return psum(part(a).mH @ part(b), mesh)

    return vdot, lambda a: torch.sqrt(vdot(a, a).abs().real), gram


def _identity(v):
    return v


def _read(t):
    """``t.item()``: a host read of a device value, for which the host waits
    on the device.  Counted in the process counter ``syncs``, spanned as
    ``htool.krylov.wait``."""
    count("syncs")
    with span("htool.krylov.wait"):
        return t.item()


def _read_list(t):
    """``t.tolist()``: one host read of several device values, counted and
    spanned as :func:`_read` does."""
    count("syncs")
    with span("htool.krylov.wait"):
        return t.tolist()


def _rhs(b, x0):
    b = torch.as_tensor(b)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    n, k = b.shape
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device).reshape(n, k)
    return b, x, squeeze


class _CGState:
    """CG's vectors and scalars.  The body (:func:`_cg_body`) reads ``b``
    and ``x``, writes ``r``, ``p``, ``rz``, ``active`` (the columns still
    above the tolerance), ``go`` (any of them), ``res`` (the largest
    relative residual), ``bnorm`` and ``tolb`` (tol · ‖b‖) in its prologue,
    and updates ``x``, ``r``, ``p``, ``rz``, ``active``, ``go`` and ``res``
    in place in each step; ``Ap`` and ``z`` live within a step."""

    def __init__(self, b, x):
        self.b, self.x = b, x


def _cg_body(s: _CGState, A, M, tol, vdot, norm):
    """CG's arithmetic as in-place updates of ``s``: ``(start, step)``, the
    prologue and the step's segments ``[(name, fn)]`` in order: the
    product, the vector updates, the preconditioner's apply and the close
    (the new search direction and the stopping test).  Run eagerly, or
    captured once and replayed (:class:`CGGraphs`); the same order of
    operations either way."""

    def start():
        bnorm = norm(s.b)
        s.bnorm = torch.where(bnorm == 0, 1.0, bnorm)
        s.tolb = tol * s.bnorm
        s.r = s.b - A(s.x)
        s.x = s.x.to(s.r.dtype)
        z = M(s.r)
        s.p = z.to(s.r.dtype, copy=True)
        s.rz = vdot(s.r, z)
        rnorm = norm(s.r)
        s.active = rnorm > s.tolb
        s.go = torch.any(s.active)
        s.res = torch.amax(rnorm / s.bnorm, dim=0)

    def product():
        s.Ap = A(s.p)

    def update():
        pAp = vdot(s.p, s.Ap)
        alpha = s.rz / torch.where(pAp == 0, 1.0, pAp)
        alpha = torch.where(s.active, alpha, 0.0)  # freeze converged columns
        s.x.add_(alpha[None, :] * s.p)
        s.r.sub_(alpha[None, :] * s.Ap)

    def apply():
        s.z = M(s.r)

    def close():
        rz_new = vdot(s.r, s.z)
        beta = rz_new / torch.where(s.rz == 0, 1.0, s.rz)
        beta = torch.where(s.active, beta, 0.0)
        torch.add(s.z, beta[None, :] * s.p, out=s.p)
        s.rz.copy_(rz_new)
        rnorm = norm(s.r)
        torch.gt(rnorm, s.tolb, out=s.active)  # the next step's, and its stopping test
        torch.any(s.active, out=s.go)
        torch.amax(rnorm / s.bnorm, dim=0, out=s.res)  # read once, after the last step

    return start, [("product", product), ("update", update), ("apply", apply), ("close", close)]


# the spans a replayed segment opens: those its eager run opens inside the
# product and the Schwarz apply, the two operands a solver hands to graphs
_SEGMENT_SPANS = {"product": lambda s: span("htool.hmatrix.product"),
                  "apply": lambda s: span("htool.schwarz.apply", device=s.r)}


class _Eager:
    """A segment run again at each replay: where CUDA graphs do not exist."""

    def __init__(self, fn):
        self.replay = fn


class _Graph:
    """A captured segment and the counts its capture made (see
    :func:`..utils.profiling.tallies`), added again at each replay."""

    def __init__(self, graph, delta):
        self.graph, self.delta = graph, delta

    def replay(self):
        self.graph.replay()
        add_tallies(self.delta)


@functools.lru_cache(maxsize=None)
def _capture_stream(index: int):
    """The side stream that every capture on device ``index`` runs on.  One
    stream per device and not one per capture: cuBLAS keeps a workspace for
    each stream it has run on for the life of the process."""
    return torch.cuda.Stream(index)


def _capture(fn, pool, stream):
    """Capture ``fn``'s work on ``stream`` into a CUDA graph in memory pool
    ``pool``.  The capture launches nothing, so the counts it made are taken
    back and kept with the graph."""
    before = tallies()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            fn()
        finally:
            graph.capture_end()
    after = tallies()
    delta = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    add_tallies(delta, -1)
    return _Graph(graph, delta)


class _GraphedCG:
    """CG's static state for one (k, dtype, tol) and its prologue and step
    segments, captured after one eager warm-up run of the body (which also
    configures the kernels).  The segments share one memory pool and are
    captured in the order they replay, so a segment's temporaries are dead
    when a later one reuses their memory; everything a step hands to the
    next is written in place into tensors the prologue made."""

    def __init__(self, A, M, b, tol, vdot, norm):
        self.state = s = _CGState(b.clone(), torch.zeros_like(b))
        start, step = _cg_body(s, A, M, tol, vdot, norm)
        start()  # warm-up
        for _, fn in step:
            fn()
        if b.device.type != "cuda":
            self.start = _Eager(start)
            self.step = [(name, _Eager(fn)) for name, fn in step]
            return
        with torch.cuda.device(b.device):
            stream = _capture_stream(torch.cuda.current_device())
            stream.wait_stream(torch.cuda.current_stream())
            pool = torch.cuda.graph_pool_handle()
            self.start = _capture(start, pool, stream)
            self.step = []
            for name, fn in step:
                if name == "apply" and M is _identity:
                    fn()  # z is r itself: nothing to launch
                    continue
                self.step.append((name, _capture(fn, pool, stream)))
            torch.cuda.current_stream().wait_stream(stream)

    def run_step(self):
        s = self.state
        for name, seg in self.step:
            opened = _SEGMENT_SPANS.get(name)
            if opened is None:
                seg.replay()
            else:
                with opened(s):
                    seg.replay()
        count("krylov_graph_steps")


class CGGraphs:
    """The CUDA graphs of :func:`cg`'s step for one operator and
    preconditioner (:class:`..ddm.DDMSolver` keeps one and hands it to
    ``cg``).  For each (k, dtype, tol) of the right-hand side the first
    solve runs the body once eagerly, then captures the prologue and the
    step's segments (one ``krylov_graph_captures``); every solve copies b
    and x0 into the static state, replays the prologue, and replays a step
    (one ``krylov_graph_steps``) after each host read of the stopping test,
    as the eager loop reads it.  ``key``: what the owner compares to decide
    whether the graphs still hold (the tensors the captures read)."""

    def __init__(self, key: tuple):
        self.key = key
        self._sets: dict = {}

    def runner(self, A, M, b, tol, vdot, norm) -> _GraphedCG:
        key = (b.shape[1], b.dtype, float(tol))
        got = self._sets.get(key)
        if got is None:
            with span("htool.krylov.capture"):
                got = self._sets[key] = _GraphedCG(A, M, b, tol, vdot, norm)
            count("krylov_graph_captures")
        return got


def cg(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 200,
    mesh=None,
    _graphs: Optional[CGGraphs] = None,
) -> KrylovResult:
    """Preconditioned conjugate gradient for SPD/HPD operators.

    ``A`` and ``M`` map [n, k] -> [n, k].  Stops when every column satisfies
    ``||b - A x|| <= tol * ||b||``.  With ``mesh``, runs on per-partition
    vector slices (dots psum over the partitions; padded slice rows must be
    zero).  ``_graphs`` (from :class:`..ddm.DDMSolver`, without ``mesh``):
    the step replayed from CUDA graphs (:class:`CGGraphs`), where x0 is
    absent or of b's dtype.
    """
    vdot, norm, _ = _dots(mesh)
    b, x, squeeze = _rhs(b, x0)
    M = M or _identity

    graphed = _graphs is not None and x.dtype == b.dtype
    if graphed:
        g = _graphs.runner(A, M, b, tol, vdot, norm)
        s = g.state
        s.b.copy_(b)
        s.x.copy_(x)
        g.start.replay()
        step = g.run_step
    else:
        s = _CGState(b, x if x0 is None else x.clone())
        start, segments = _cg_body(s, A, M, tol, vdot, norm)
        start()

        def step():
            for _, fn in segments:
                fn()

    it = 0
    go = it < maxiter and _read(s.go)
    while go:
        with span("htool.krylov.step"):  # a step ends with the next one's stopping test
            step()
            it += 1
            go = it < maxiter and _read(s.go)
    res = _read(s.res)
    x = s.x.clone() if graphed else s.x  # the static x is overwritten by the next solve
    out = x[:, 0] if squeeze else x
    return KrylovResult(out, it, res, res <= tol)


def gmres(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 200,
    restart: int = 40,
    mesh=None,
) -> KrylovResult:
    """Left-preconditioned restarted GMRES(m) with modified Gram-Schmidt and
    Givens rotations, vectorized over RHS columns.

    Iterates on the preconditioned system ``M A x = M b``; the convergence
    test uses the preconditioned residual (HPDDM's default), with the final
    reported residual recomputed unpreconditioned.  With ``mesh``, runs on
    per-partition vector slices.
    """
    _vdot_cols, _norm_cols, _ = _dots(mesh)
    b, x, squeeze = _rhs(b, x0)
    n, k = b.shape
    M = M or _identity
    Ax = A(x)  # first residual; also fixes the working dtype
    dtype = torch.promote_types(b.dtype, Ax.dtype)
    b = b.to(dtype)
    x = x.to(dtype)
    m = int(min(restart, maxiter))
    dev = b.device

    bnorm = _norm_cols(M(b))
    bnorm = torch.where(bnorm == 0, 1.0, bnorm)

    it = 0
    res = float("inf")
    while it < maxiter and res > tol:
        r = M(b - (Ax if Ax is not None else A(x))).to(dtype)  # [n, k]
        Ax = None
        beta = _norm_cols(r)  # [k]
        # Krylov basis: V [m+1, n, k]
        V = torch.zeros((m + 1, n, k), dtype=dtype, device=dev)
        V[0] = r / torch.where(beta == 0, 1.0, beta)[None, :]
        # Hessenberg (after Givens): H [m+1, m, k]; Givens coeffs cs/sn [m, k]
        H = torch.zeros((m + 1, m, k), dtype=dtype, device=dev)
        cs = torch.zeros((m, k), dtype=dtype, device=dev)
        sn = torch.zeros((m, k), dtype=dtype, device=dev)
        g = torch.zeros((m + 1, k), dtype=dtype, device=dev)
        g[0] = beta.to(dtype)

        # after j steps the rotated residual of each column is |g[j]|
        j = 0
        go = j < m and _read(torch.any(g[j].abs() / bnorm > tol))
        while go:
            with span("htool.krylov.step"):
                w = M(A(V[j])).to(dtype)  # [n, k]

                # modified Gram-Schmidt against V[0..j]
                hcol = torch.zeros((m + 1, k), dtype=dtype, device=dev)
                for i in range(j + 1):
                    hij = _vdot_cols(V[i], w)
                    w = w - hij[None, :] * V[i]
                    hcol[i] = hij
                hlast = _norm_cols(w).to(dtype)
                hcol[j + 1] = hlast
                V[j + 1] = w / torch.where(hlast.abs() == 0, 1.0, hlast)[None, :]

                # apply previous Givens rotations to the new column.
                # Convention: G = [[c, s], [-conj(s), c]] with c real >= 0.
                for i in range(j):
                    t1 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                    t2 = -sn[i].conj() * hcol[i] + cs[i] * hcol[i + 1]
                    hcol[i] = t1
                    hcol[i + 1] = t2

                # new Givens zeroing hcol[j+1]:
                # c = |h1|/d, s = phase(h1) * conj(h2)/d  ->  G [h1; h2] = [phase*d; 0]
                h1, h2 = hcol[j].clone(), hcol[j + 1].clone()
                denom = torch.sqrt(h1.abs() ** 2 + h2.abs() ** 2)
                denom_s = torch.where(denom == 0, 1.0, denom)
                absh1 = h1.abs()
                phase = torch.where(
                    absh1 == 0, torch.ones_like(h1),
                    h1 / torch.where(absh1 == 0, 1.0, absh1).to(h1.dtype),
                )
                c_new = (absh1 / denom_s).to(dtype)
                s_new = (phase * h2.conj() / denom_s.to(h1.dtype)).to(dtype)
                cs[j] = c_new
                sn[j] = s_new
                hcol[j] = c_new * h1 + s_new * h2
                hcol[j + 1] = 0.0
                H[:, j, :] = hcol

                # update residual vector g
                g1, g2 = g[j].clone(), g[j + 1].clone()
                g[j] = c_new * g1 + s_new * g2
                g[j + 1] = -s_new.conj() * g1 + c_new * g2
                it += 1
                j += 1
                go = j < m and _read(torch.any(g[j].abs() / bnorm > tol))

        # back-substitute H y = g over the j leading columns
        y = torch.zeros((m, k), dtype=dtype, device=dev)
        for i in reversed(range(j)):
            num = g[i] - torch.sum(H[i] * y, dim=0)
            hii = H[i, i]
            y[i] = num / torch.where(hii.abs() == 0, 1.0, hii)
        x = x + torch.einsum("jnk,jk->nk", V[:m], y)
        res = _read(torch.max(_norm_cols(M(b - A(x))) / bnorm))

    # report the TRUE (unpreconditioned) relative residual
    tnorm = _norm_cols(b)
    tnorm = torch.where(tnorm == 0, 1.0, tnorm)
    true_res = _read(torch.max(_norm_cols(b - A(x)) / tnorm))
    out = x[:, 0] if squeeze else x
    return KrylovResult(out, it, true_res, res <= tol)


def _wide(dtype: torch.dtype) -> torch.dtype:
    """float64 / complex128: the dtype of block GMRES's small problems."""
    return torch.complex128 if dtype.is_complex else torch.float64


def _pivoted_cholesky(G, floor):
    """``(F, pivots, kept, least)`` with G ≈ F Fᴴ for the Hermitian PSD G
    [mu, mu]: column k of F belongs to ``pivots[k]``, the greatest
    remaining diagonal of the Schur complement first; ``kept[k]`` whether
    that pivot exceeds ``floor``; ``least`` the last pivot.  Pivots so taken
    never grow, so ``least`` is the smallest, the kept steps come first,
    and a step not kept leaves F's column zero.  Device arithmetic only, no
    host read: a pivot is a device index, used to gather and scatter."""
    mu = G.shape[0]
    S = G.clone()
    free = torch.ones(mu, dtype=torch.bool, device=G.device)
    cols, pivots, kept = [], [], []
    for _ in range(mu):
        least, p = torch.max(torch.where(free, S.diagonal().real, -1.0), dim=0)
        ok = least > floor
        col = S.index_select(1, p.view(1))[:, 0]
        # rows pivoted before stay exactly zero; a step not kept is all zero
        col = col * torch.where(free & ok, torch.rsqrt(least), 0.0)
        S = S - col[:, None] * col.conj()[None, :]
        free = free.index_fill(0, p.view(1), False)
        cols.append(col)
        pivots.append(p)
        kept.append(ok)
    return torch.stack(cols, 1), torch.stack(pivots), torch.stack(kept), least


def _block_qr(W, gram):
    """QR of the tall block W [n, mu] through Gram matrices alone (``gram``:
    aᴴ b, summed over the partitions under a mesh), safe when W loses rank:
    ``(Q, R, lost)`` with W ≈ Q R, Q in W's dtype with orthonormal columns
    or zero ones, R [mu, mu] in double.

    Two passes of CholeskyQR in double precision (``_wide``).  The first
    scales W's columns to unit norm and factors their Gram matrix by a
    pivoted Cholesky.  A remaining pivot is the squared sine between a
    column and the span of those taken before it; below the double Gram's
    resolution (mu times the larger of W's rounding squared and double
    rounding over n-term sums) the column is deflated: its column of Q and
    its row of R are zero.  The second pass factors the Gram matrix of the
    kept columns again, which restores their orthogonality to double
    rounding.  R is upper triangular up to the pivots' order of columns.

    ``lost`` (a device bool): the block lost rank in its own precision, a
    pivot below what a Gram matrix in W's dtype resolves (eps · √n, where a
    Cholesky of that Gram fails) or a column deflated."""
    n, mu = W.shape
    small = _wide(W.dtype)
    eps, root_n = torch.finfo(W.dtype).eps, math.sqrt(max(n, 1))
    X = W.to(small)
    G = gram(X, X)
    d = torch.sqrt(G.diagonal().real)
    ds = torch.where(d > 0, d, 1.0)
    floor = mu * max(eps ** 2, torch.finfo(small).eps * root_n)
    F, pivots, kept, least = _pivoted_cholesky(G / torch.outer(ds, ds), floor)
    R1 = F.mH * d  # X ≈ Q1 R1
    unit = torch.diag((~kept).to(small))  # keeps the factors invertible where not kept
    T = F.mH.index_select(1, pivots) + unit  # upper triangular
    Q1 = torch.linalg.solve_triangular(T, (X / ds).index_select(1, pivots), upper=True,
                                       left=False) * kept
    R2 = torch.linalg.cholesky_ex(gram(Q1, Q1) + unit).L.mH
    Q = torch.linalg.solve_triangular(R2, Q1, upper=True, left=False)
    return Q.to(W.dtype), R2 @ R1, (least < eps * root_n) | ~torch.all(kept)


def _lstsq_residual(Hm, gm):
    """Minimum-norm solution of min ‖Hm Y − gm‖ through the SVD, with the
    reference's cut of singular values below eps · max(shape) · s_max, and
    the residual norm of each column."""
    U, s, Vh = torch.linalg.svd(Hm, full_matrices=False)
    keep = s >= torch.finfo(s.dtype).eps * max(Hm.shape) * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0).to(Hm.dtype)
    Y = Vh.mH @ (s_inv[:, None] * (U.mH @ gm))
    r = gm - Hm @ Y
    return Y, torch.sqrt(torch.sum(r.abs() ** 2, dim=0))


def block_gmres(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 200,
    restart: int = 20,
    mesh=None,
) -> KrylovResult:
    """Block GMRES(m): all right-hand-side columns share ONE Krylov subspace
    (block Arnoldi with blocked modified Gram-Schmidt + QR), so one operator
    application on the [n, mu] block advances every column — HPDDM's block
    methods, against :func:`gmres`, which iterates the columns jointly but
    with independent subspaces.

    ``maxiter`` counts BLOCK iterations (operator applications on the
    block).  The small least-squares problem min‖H̄ Y − E₁S‖_F, at most
    (m+1)·mu × m·mu, is solved again at every step for the stopping test.

    One difference from the reference, which keeps everything in the working
    dtype: the small problems (the block Hessenberg matrix, the Cholesky
    factors, the least squares) are held in double precision whatever the
    vectors' dtype.  In float64 / complex128 that changes nothing.  In
    float32 / complex64 the single-precision least-squares residual cannot
    be resolved much below 1e-6 of ‖M b‖, so at ``tol = 1e-6`` the stopping
    test sat on rounding noise and the count of one solve changed from run
    to run on the GPU (its atomics reorder the sums); in double it does not.
    With ``mesh``, runs on per-partition vector slices (the Gram products
    psum over the partitions).
    """
    _vdot_cols, _norm_cols, gram = _dots(mesh)
    b = torch.as_tensor(b)
    if b.ndim == 1:
        raise ValueError("block_gmres needs a 2-D [n, mu] right-hand side")
    b, x, _ = _rhs(b, x0)
    n, mu = b.shape
    M = M or _identity
    Ax = A(x)  # first residual; also fixes the working dtype
    dtype = torch.promote_types(b.dtype, Ax.dtype)
    b = b.to(dtype)
    x = x.to(dtype)
    m = int(min(restart, maxiter))
    dev = b.device
    small = _wide(dtype)

    bnorm = _norm_cols(M(b))
    bnorm = torch.where(bnorm == 0, 1.0, bnorm)

    it = 0
    res_now = float("inf")
    lost_blocks = torch.zeros((), dtype=torch.int64, device=dev)  # see _block_qr
    while it < maxiter and res_now > tol:
        R0 = M(b - (Ax if Ax is not None else A(x))).to(dtype)
        Ax = None
        V0, S, lost = _block_qr(R0, gram)
        lost_blocks += lost
        V = torch.zeros((m + 1, n, mu), dtype=dtype, device=dev)
        V[0] = V0
        # block Hessenberg, flattened: block (i, j) at rows i·mu.., cols j·mu..
        H = torch.zeros(((m + 1) * mu, m * mu), dtype=small, device=dev)
        g = torch.zeros(((m + 1) * mu, mu), dtype=small, device=dev)
        g[:mu] = S

        j = 0
        res = torch.full((mu,), float("inf"), dtype=bnorm.dtype, device=dev)
        go = j < m and it < maxiter and _read(torch.any(res > tol))
        while go:
            with span("htool.krylov.step"):
                W = M(A(V[j])).to(dtype)
                with span("htool.krylov.orth", device=dev):
                    for i in range(j + 1):  # blocked modified Gram-Schmidt
                        Hij = gram(V[i], W)
                        W = W - V[i] @ Hij
                        H[i * mu : (i + 1) * mu, j * mu : (j + 1) * mu] += Hij
                    Q, Rj, lost = _block_qr(W, gram)
                    lost_blocks += lost
                    H[(j + 1) * mu : (j + 2) * mu, j * mu : (j + 1) * mu] = Rj
                    V[j + 1] = Q
                it += 1
                j += 1
                with span("htool.krylov.lstsq", device=dev):
                    _, r = _lstsq_residual(H[: (j + 1) * mu, : j * mu], g[: (j + 1) * mu])
                res = r.to(bnorm.dtype) / bnorm
                go = j < m and it < maxiter and _read(torch.any(res > tol))

        with span("htool.krylov.lstsq", device=dev):
            Y, _ = _lstsq_residual(H[: (j + 1) * mu, : j * mu], g[: (j + 1) * mu])
        x = x + torch.einsum("jnp,jpq->nq", V[:j], Y.view(j, mu, mu).to(dtype))
        res_now = _read(torch.max(_norm_cols(M(b - A(x))) / bnorm))

    tnorm = _norm_cols(b)
    tnorm = torch.where(tnorm == 0, 1.0, tnorm)
    # the tally of blocks that lost rank rides on the last read
    true_res, n_lost = _read_list(torch.stack([torch.max(_norm_cols(b - A(x)) / tnorm),
                                               lost_blocks.to(tnorm.dtype)]))
    count("krylov_block_rank_deficient", int(n_lost))
    return KrylovResult(x, it, true_res, res_now <= tol)
