"""Solver option registry — the HPDDM option-string analog.

The reference configures its solver stack through HPDDM's option registry
parsed from argv/strings (``-hpddm_krylov_method``, ``-hpddm_schwarz_method
{none,ras,asm}``, ``-hpddm_schwarz_coarse_correction {additive,deflated,
balanced}``, ``-hpddm_geneo_nu``, ``-hpddm_max_it``, ``-hpddm_tol``,
``-hpddm_verbosity`` — usage at ``solvers/ddm.hpp:90-91,135-155,238-323``).
This module provides the same surface as a dataclass + string/argv parser,
accepting both ``-hpddm_*`` spellings (compatibility) and bare names.

A copy of ``htool_tpu/utils/options.py`` (no JAX in it).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Optional

__all__ = ["SolverOptions"]


@dataclass
class SolverOptions:
    krylov_method: str = "gmres"  # -hpddm_krylov_method {cg, gmres}
    schwarz_method: str = "ras"  # -hpddm_schwarz_method {none, jacobi, asm, ras}
    schwarz_coarse_correction: Optional[str] = None  # {additive, deflated, balanced}
    geneo_nu: int = 20  # -hpddm_geneo_nu
    geneo_threshold: float = -1.0  # -hpddm_geneo_threshold
    max_it: int = 100  # -hpddm_max_it
    tol: float = 1e-6  # -hpddm_tol
    gmres_restart: int = 40  # -hpddm_gmres_restart
    verbosity: int = 0  # -hpddm_verbosity
    overlap_radius: float = 0.0
    local_solver: str = "dense"  # {dense, blr}

    _CHOICES = {
        "krylov_method": {"cg", "gmres"},
        "schwarz_method": {"none", "jacobi", "asm", "ras"},
        "schwarz_coarse_correction": {None, "additive", "deflated", "balanced"},
        "local_solver": {"dense", "blr"},
    }

    def __post_init__(self):
        for name, choices in self._CHOICES.items():
            v = getattr(self, name)
            if v not in choices:
                raise ValueError(
                    f"invalid {name}={v!r}; choose from {sorted(c for c in choices if c is not None)}"
                )

    # ------------------------------------------------------------------
    @classmethod
    def parse(cls, args) -> "SolverOptions":
        """Parse ``-hpddm_*``-style options from an argv list or a string.

        >>> SolverOptions.parse("-hpddm_krylov_method cg -hpddm_tol 1e-8")
        """
        if isinstance(args, str):
            args = args.split()
        known = {f.name: f for f in fields(cls) if not f.name.startswith("_")}
        kwargs = {}
        i = 0
        while i < len(args):
            tok = str(args[i])
            if not tok.startswith("-"):
                i += 1
                continue
            name = tok.lstrip("-")
            if name.startswith("hpddm_"):
                name = name[len("hpddm_") :]
            if name not in known:
                raise ValueError(f"unknown solver option {tok!r}")
            if i + 1 >= len(args):
                raise ValueError(f"option {tok!r} requires a value")
            raw = str(args[i + 1])
            typ = known[name].type
            if typ in (int, "int"):
                kwargs[name] = int(raw)
            elif typ in (float, "float"):
                kwargs[name] = float(raw)
            elif name == "schwarz_coarse_correction" and raw in ("none", "None"):
                kwargs[name] = None
            else:
                kwargs[name] = raw
            i += 2
        return cls(**kwargs)

    def solve_kwargs(self) -> dict:
        """kwargs for :meth:`DDMSolver.solve`."""
        return dict(
            tol=self.tol,
            maxiter=self.max_it,
            krylov=self.krylov_method,
            restart=self.gmres_restart,
        )

    def solver_kwargs(self) -> dict:
        """kwargs for :class:`DDMSolver` construction (one-level part)."""
        return dict(
            schwarz=self.schwarz_method,
            overlap_radius=self.overlap_radius,
            local_solver=self.local_solver,
            coarse_correction=self.schwarz_coarse_correction or "additive",
        )
