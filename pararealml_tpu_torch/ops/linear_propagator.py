"""Exact affine propagators: linear-problem trajectories as matmuls.

Port of the JAX package's ``ops/linear_propagator.py``. For a linear
differential equation with static boundary conditions and an explicit
integrator, one FDM time step is an *affine* map of the flattened state
vector::

    y_{k+1} = S @ y_k + q

with a constant ``(dim, dim)`` matrix ``S`` and offset ``q`` (Dirichlet
application, Neumann ghost synthesis and every explicit Runge-Kutta stage
are themselves affine, so the composition is too). This module recovers
``(S, q)`` exactly by probing the generic step function with the standard
basis — one batched step over ``eye(dim)`` — and reformulates the
trajectory as chains of matmuls against ``S``:

- end states skip the interior entirely: ``y_n = P y_0 + r`` with
  ``(P, r)`` the ``n``-step composition, built once through the binary
  expansion of ``n``, so an end state is one matvec (one ``(B, dim) x
  (dim, dim)`` matmul for a batch of Parareal slices);
- trajectory interiors expand chunk-at-a-time from precomputed powers
  ``[S^1 .. S^c]``, with the chunk-boundary states from a log-depth
  doubling scan where the chunk scan is deep;
- the composed map itself (``affine_slice_map``) lets the Parareal
  operator run its coarse sweeps as log-depth doubling scans.

These are plain products, not kernels of this repository: they run
through ``torch.matmul`` in the state's dtype, as the JAX package leaves
them to XLA. Every float32 product here runs in full IEEE fp32
(:func:`full_fp32_matmul`): the JAX package measured that anything less
than the full-precision composition doubles the Parareal error past the
termination tolerance.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import sympy as sp
import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.differential_equation import LHS

# S alone is dim^2; beyond this the dense formulation loses to stencils
_MAX_DIM = 4096
# element budget for the stacked chunk powers [S^1..S^c] used to expand
# trajectory interiors chunk-at-a-time (64 MB of f32)
_MAX_CHUNK_STACK_ELEMS = 16_777_216


@contextlib.contextmanager
def full_fp32_matmul():
    """Runs the float32 matmuls inside the block at full IEEE fp32 on
    the card, and restores the caller's settings afterwards.

    Both switches are set explicitly: ``allow_tf32 = False`` and the
    ``"highest"`` float32 matmul precision. TF32 keeps about three
    decimal digits, and chained propagator products at that precision
    miss the Parareal tolerance (the JAX package's finding with its
    reduced-precision MXU passes)."""
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    saved_precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved_precision)
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32


def _all_symbol_arrays(symbols):
    arrays = [symbols.y]
    for name in (
        "y_gradient",
        "y_hessian",
        "y_divergence",
        "y_curl",
        "y_laplacian",
        "y_vector_laplacian",
    ):
        array = getattr(symbols, name)
        if array is not None:
            arrays.append(array)
    return arrays


def equation_system_is_affine(diff_eq) -> bool:
    """Whether every RHS expression is affine in the solution-dependent
    symbols (y and all its differential operators) with no explicit
    time dependence — the condition under which one explicit FDM step is
    an affine map of the state vector."""
    symbols = diff_eq.symbols
    t = symbols.t
    y_symbols = {
        s
        for array in _all_symbol_arrays(symbols)
        for s in np.asarray(array).flatten()
    }
    for expr in diff_eq.symbolic_equation_system.rhs:
        expr = sp.sympify(expr)
        free = expr.free_symbols
        if t in free:
            return False
        present = sorted(free & y_symbols, key=str)
        if not present:
            continue
        try:
            poly = sp.Poly(expr, *present)
        except sp.PolynomialError:
            return False
        if poly.total_degree() > 1:
            return False
    return True


def linear_propagator_applicable(
    cp: ConstrainedProblem, integrator, max_dim: int = _MAX_DIM
) -> bool:
    """Whether the affine-propagator formulation reproduces the generic
    step for this problem/integrator combination."""
    from pararealml_tpu_torch.operators.fdm.numerical_integrator import (
        RK4,
        ExplicitMidpointMethod,
        ForwardEulerMethod,
    )

    diff_eq = cp.differential_equation
    if not isinstance(
        integrator, (ForwardEulerMethod, ExplicitMidpointMethod, RK4)
    ):
        return False
    eq_sys = diff_eq.symbolic_equation_system
    if eq_sys.equation_indices_by_type(LHS.Y_LAPLACIAN):
        # the anti-Laplacian's data-dependent early exit breaks exact
        # affinity
        return False
    if diff_eq.x_dimension:
        if not cp.are_all_boundary_conditions_static:
            return False
        dim = int(np.prod(cp.y_shape(True)))
    else:
        dim = diff_eq.y_dimension
    if dim > max_dim:
        return False
    return equation_system_is_affine(diff_eq)


def probe_affine_step(
    step_fn: Callable,
    y_shape: Tuple[int, ...],
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recovers ``(S, q)`` with ``step(y) == S @ vec(y) + q`` by probing
    ``step_fn(y, i, t)`` with the standard basis and the zero state —
    one batched step over ``eye(dim)`` and a zero row — and verifies
    affinity on a random state (guarding against a dispatch bug routing
    a nonlinear problem here).
    """
    if dtype is None:
        dtype = torch.get_default_dtype()
    y_shape = tuple(y_shape)
    dim = int(np.prod(y_shape))
    probes = torch.cat(
        [
            torch.eye(dim, dtype=dtype, device=device),
            torch.zeros((1, dim), dtype=dtype, device=device),
        ]
    ).reshape((dim + 1,) + y_shape)
    out = step_fn(probes, 0, 0.0).reshape(dim + 1, dim)
    cols, q = out[:dim], out[dim]
    s_matrix = (cols.T - q[:, None]).contiguous()

    rng = np.random.default_rng(0)
    y_random = torch.as_tensor(
        rng.standard_normal(dim), dtype=dtype, device=device
    )
    direct = (
        step_fn(y_random.reshape(y_shape), 0, 0.0)
        .reshape(dim)
        .to(torch.float64)
        .cpu()
        .numpy()
    )
    with full_fp32_matmul():
        via_affine = (
            (torch.matmul(s_matrix, y_random) + q)
            .to(torch.float64)
            .cpu()
            .numpy()
        )
    scale = max(1.0, float(np.abs(direct).max()))
    deviation = float(np.abs(direct - via_affine).max()) / scale
    if not np.isfinite(deviation) or deviation > 1e-3:
        raise ValueError(
            "step function is not affine in the state (max relative "
            f"deviation {deviation:.2e}); the linear-propagator "
            "applicability check should have rejected this problem"
        )
    return s_matrix, q


def _binary_power_chain(
    s_matrix: torch.Tensor, q: torch.Tensor, n_steps: int
) -> List[Tuple[torch.Tensor, torch.Tensor, bool]]:
    """``[(S^(2^i), r_i, bit_i)]`` for every bit needed to compose the
    ``n_steps``-step affine map, built by repeated squaring: the affine
    composition rule is ``(S2, q2) o (S1, q1) = (S2 S1, S2 q1 + q2)``."""
    chain = []
    p, r = s_matrix, q
    bits = n_steps
    with full_fp32_matmul():
        while bits:
            chain.append((p, r, bool(bits & 1)))
            bits >>= 1
            if bits:
                p, r = (
                    torch.matmul(p, p),
                    torch.matmul(p, r[:, None])[:, 0] + r,
                )
    return chain


class _DeviceConstants:
    """A dict of constant tensors built on one device, copied to any
    other device a state arrives on (memoized): the state's device
    wins."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self._built_on = next(iter(tensors.values())).device
        self._by_device = {self._built_on: tensors}

    def on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        tensors = self._by_device.get(device)
        if tensors is None:
            tensors = {
                name: value.to(device)
                for name, value in self._by_device[self._built_on].items()
            }
            self._by_device[device] = tensors
        return tensors


def build_linear_propagator_trajectory(
    cp: ConstrainedProblem,
    step_fn: Callable,
    n_steps: int,
    y_shape: Tuple[int, ...],
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> Callable:
    """Builds ``trajectory(y, t_0) -> ys`` computing ``n_steps`` steps of
    the affine step map as chains of matmuls against ``S``.

    ``y`` may carry leading batch axes (Parareal's slices): each
    expansion step is then one ``(B, dim) x (dim, ...)`` matmul over the
    batch. The function also exposes ``end_function``, a one-matmul map
    to the trajectory's final state, and ``affine_slice_map``, the
    composed ``n_steps``-step map ``(P^T, r)`` in the row-vector
    convention ``y_end = y @ P^T + r``.
    """
    if dtype is None:
        dtype = torch.get_default_dtype()
    y_shape = tuple(y_shape)
    dim = int(np.prod(y_shape))
    s_matrix, q = probe_affine_step(step_fn, y_shape, dtype, device)
    # row-vector convention so a batch contracts as (B, dim) x (dim, dim)
    s_t = s_matrix.T.contiguous()
    chain = _binary_power_chain(s_matrix, q, n_steps)

    # chunked interior expansion: with the stacked powers
    # [S^1.T .. S^c.T] ((dim, c*dim) flattened), a whole chunk of c
    # trajectory states is ONE (B, dim) x (dim, c*dim) matmul from the
    # chunk-start state
    chunk = max(
        1, min(64, n_steps, _MAX_CHUNK_STACK_ELEMS // (dim * dim))
    )
    if chunk > 1 and n_steps % chunk:
        # prefer an exact divisor of n_steps within 2x of the cap (the
        # padded tail otherwise costs a truncation copy and up to
        # chunk-1 wasted states)
        for candidate in range(chunk, chunk // 2, -1):
            if n_steps % candidate == 0:
                chunk = candidate
                break
    constants = {"s_t": s_t, "q": q}
    use_doubling = False
    n_chunks = -(-n_steps // chunk)
    with full_fp32_matmul():
        if chunk > 1:
            pow_ts, offsets = [s_t], [q]
            for _ in range(chunk - 1):
                pow_ts.append(torch.matmul(pow_ts[-1], s_t))
                offsets.append(torch.matmul(offsets[-1], s_t) + q)
            constants["pow_flat"] = torch.stack(pow_ts, dim=1).reshape(
                dim, chunk * dim
            )
            constants["offset_stack"] = torch.stack(offsets, dim=0)

            # chunk-BOUNDARY states are themselves an affine recurrence
            # in the chunk index (z_{k+1} = S^c z_k + r_c), so they come
            # from a log-depth Hillis-Steele doubling scan over
            # precomputed (S^c)^(2^l); with every chunk start known, ALL
            # interiors are one batched matmul. The thresholds are the
            # JAX package's, tuned on a TPU v5e (doubling won on deep
            # chunk scans and lost on shallow ones); re-tuning them for
            # the H100 is later work.
            boundary_levels = (n_chunks - 1).bit_length()
            itemsize = torch.empty((), dtype=dtype).element_size()
            use_doubling = (
                n_chunks >= 16
                and boundary_levels * dim * dim * itemsize <= 128 * 2**20
            )
            if use_doubling:
                constants["chunk_pt"] = pow_ts[chunk - 1]  # (S^c).T
                constants["chunk_r"] = offsets[chunk - 1]
                boundary_pows = [pow_ts[chunk - 1]]
                for _ in range(boundary_levels - 1):
                    boundary_pows.append(
                        torch.matmul(boundary_pows[-1], boundary_pows[-1])
                    )
                for level, power in enumerate(boundary_pows):
                    constants[f"boundary_pow_{level}"] = power
                n_levels = len(boundary_pows)

        # the composed n_steps-step affine map (P, r), folded from the
        # binary chain once (row-vector convention: y_end = y @ P.T + r)
        p_total = torch.eye(dim, dtype=dtype, device=s_matrix.device)
        r_total = torch.zeros(dim, dtype=dtype, device=s_matrix.device)
        for p, r, take in chain:
            if take:
                p_total = torch.matmul(p, p_total)
                r_total = torch.matmul(p, r_total[:, None])[:, 0] + r
    p_total_t = p_total.T.contiguous()
    constants["p_total_t"] = p_total_t
    constants["r_total"] = r_total
    device_constants = _DeviceConstants(constants)

    def _flatten(y):
        lead = tuple(y.shape[: y.ndim - len(y_shape)])
        if tuple(y.shape[len(lead):]) != y_shape:
            raise ValueError(
                f"state shape {tuple(y.shape)} does not end with the "
                f"problem's {y_shape}"
            )
        return lead, y.to(dtype).reshape(-1, dim)

    def trajectory(y, t_0=None):
        lead, y_flat = _flatten(y)
        c = device_constants.on(y.device)
        batch = y_flat.shape[0]
        with full_fp32_matmul():
            if chunk > 1 and use_doubling:
                # w_0 = S^c y + r_c seeds the prefix; v_k = z_{k+1}
                w = c["chunk_r"].expand(batch, n_chunks, dim).clone()
                w[:, 0] += torch.matmul(y_flat, c["chunk_pt"])
                v = w
                for level in range(n_levels):
                    shift = 1 << level
                    shifted = torch.cat(
                        [v.new_zeros((batch, shift, dim)), v[:, :-shift]],
                        dim=1,
                    )
                    v = v + torch.matmul(
                        shifted, c[f"boundary_pow_{level}"]
                    )
                starts = torch.cat([y_flat[:, None], v[:, :-1]], dim=1)
                ys = torch.matmul(starts, c["pow_flat"]).reshape(
                    batch, n_chunks, chunk, dim
                ) + c["offset_stack"]
                ys = ys.reshape(batch, n_chunks * chunk, dim)[:, :n_steps]
            elif chunk > 1:
                carry = y_flat
                pieces = []
                for _ in range(n_chunks):
                    states = torch.matmul(carry, c["pow_flat"]).reshape(
                        batch, chunk, dim
                    ) + c["offset_stack"]
                    pieces.append(states)
                    carry = states[:, -1]
                ys = torch.cat(pieces, dim=1)[:, :n_steps]
            else:
                carry = y_flat
                pieces = []
                for _ in range(n_steps):
                    carry = torch.matmul(carry, c["s_t"]) + c["q"]
                    pieces.append(carry)
                ys = torch.stack(pieces, dim=1)
        return ys.reshape(lead + (n_steps,) + y_shape).to(y.dtype)

    def end_state(y, t_0=None):
        """The trajectory's final state only — one matmul against the
        composed ``n_steps``-step map."""
        lead, y_flat = _flatten(y)
        c = device_constants.on(y.device)
        with full_fp32_matmul():
            out = torch.matmul(y_flat, c["p_total_t"]) + c["r_total"]
        return out.reshape(lead + y_shape).to(y.dtype)

    trajectory.end_function = end_state
    trajectory.affine_slice_map = (p_total_t, r_total)
    trajectory.vmappable = True
    return trajectory
