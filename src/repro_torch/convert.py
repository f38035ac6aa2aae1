"""Carry the reference package's PLAN and EXECUTE state into the port.

FFCz has no weights: the state that crosses between the two packages is the
whole-field plan and the loop result.  Both functions take the reference
dataclass's fields as plain numpy arrays and Python scalars (for example
``{k: np.asarray(v) for k, v in dataclasses.asdict(ref_plan).items()}``,
with ``None`` kept as ``None``) and build the port's dataclass, so one
package's PLAN can feed the other's EXECUTE and one's result the other's
ENCODE.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.engine import FieldPlan, FieldResult


def _scalar_or_grid(v, dtype):
    a = np.asarray(v)
    return float(a) if a.ndim == 0 else np.array(a, dtype=dtype)


def plan_from_reference(d: dict) -> FieldPlan:
    """A :class:`FieldPlan` from the reference ``FieldPlan``'s fields."""
    names = {f.name for f in dataclasses.fields(FieldPlan)}
    if set(d) != names:
        raise ValueError(f"plan fields differ: extra {set(d) - names}, missing {names - set(d)}")
    grid = lambda v: None if v is None else np.array(v, dtype=np.float32)  # noqa: E731
    return FieldPlan(
        shape=tuple(int(n) for n in np.asarray(d["shape"]).reshape(-1)),
        E=float(d["E"]),
        Delta=_scalar_or_grid(d["Delta"], np.float32),
        E_proj=float(d["E_proj"]),
        Delta_proj=_scalar_or_grid(d["Delta_proj"], np.float32),
        slack_f=float(d["slack_f"]),
        pointwise=bool(d["pointwise"]),
        quant_bits=int(d["quant_bits"]),
        max_iters=int(d["max_iters"]),
        relax=float(d["relax"]),
        use_kernels=bool(d["use_kernels"]),
        codec=str(d["codec"]),
        fft_impl=str(d["fft_impl"]),
        check_every=int(d["check_every"]),
        warm_start=bool(d["warm_start"]),
        E_grid=grid(d["E_grid"]),
        E_grid_proj=grid(d["E_grid_proj"]),
    )


def result_from_reference(d: dict) -> FieldResult:
    """A :class:`FieldResult` from the reference ``FieldResult``'s fields."""
    names = {f.name for f in dataclasses.fields(FieldResult)}
    if set(d) != names:
        raise ValueError(f"result fields differ: extra {set(d) - names}, missing {names - set(d)}")
    return FieldResult(
        eps=np.array(d["eps"], dtype=np.float64),
        spat=np.array(d["spat"], dtype=np.float64),
        freq=np.array(d["freq"], dtype=np.complex128),
        iterations=int(d["iterations"]),
        converged=bool(d["converged"]),
        final_violations=int(d["final_violations"]),
    )
