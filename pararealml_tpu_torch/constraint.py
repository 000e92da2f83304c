"""Dense value constraints on tensors.

Port of the JAX package's ``constraint.py``: a constraint is two dense,
same-shaped tensors — a boolean ``mask`` and a ``values`` tensor whose
entries are meaningful only where the mask is ``True`` — and application
is an element-wise ``torch.where``. The tensors are kept as built (on the
CPU, in float64 for values built from NumPy) and copied to the dtype and
device of the array they are applied to on first use; the copies are
memoized on the constraint, so a solver's step loop converts each
constraint once.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


class Constraint:
    """A dense representation of constraints on an array.

    Both ``mask`` and ``values`` span the full constrained region;
    unconstrained positions carry a ``False`` mask bit and their value
    entries are ignored.
    """

    def __init__(self, values: Array, mask: Array):
        values = torch.as_tensor(values)
        mask = torch.as_tensor(mask, dtype=torch.bool)
        if values.shape != mask.shape:
            raise ValueError(
                f"values shape {tuple(values.shape)} must match mask shape "
                f"{tuple(mask.shape)}"
            )
        self._values = values
        self._mask = mask
        self._converted: Dict[
            Tuple[torch.dtype, torch.device], Tuple[torch.Tensor, torch.Tensor]
        ] = {}

    @property
    def values(self) -> torch.Tensor:
        """The dense constraint value tensor."""
        return self._values

    @property
    def mask(self) -> torch.Tensor:
        """The boolean tensor flagging which positions are constrained."""
        return self._mask

    @property
    def shape(self):
        return tuple(self._mask.shape)

    def tensors_like(
        self, array: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(values, mask)`` in the dtype and on the device of
        ``array`` (memoized per dtype and device)."""
        key = (array.dtype, array.device)
        converted = self._converted.get(key)
        if converted is None:
            converted = (
                self._values.to(dtype=array.dtype, device=array.device),
                self._mask.to(device=array.device),
            )
            self._converted[key] = converted
        return converted

    def apply(self, array: Array) -> torch.Tensor:
        """Returns a copy of ``array`` with constrained positions replaced
        by the constraint values (broadcasts over leading axes)."""
        array = torch.as_tensor(array)
        self._check_broadcastable(array.shape)
        values, mask = self.tensors_like(array)
        return torch.where(mask, values, array)

    def multiply_and_add(
        self,
        addend: torch.Tensor,
        multiplier: float,
        result: torch.Tensor,
    ) -> torch.Tensor:
        """Returns ``result`` with constrained positions set to
        ``addend + multiplier * values`` (the Neumann ghost-cell
        primitive)."""
        self._check_broadcastable(result.shape)
        values, mask = self.tensors_like(result)
        return torch.where(mask, addend + multiplier * values, result)

    def _check_broadcastable(self, shape):
        mask_shape = tuple(self._mask.shape)
        shape = tuple(shape)
        if len(shape) < len(mask_shape) or (
            shape[len(shape) - len(mask_shape):] != mask_shape
            and mask_shape != ()
        ):
            raise ValueError(
                f"array shape {shape} incompatible with constraint shape "
                f"{mask_shape}"
            )

    @classmethod
    def from_nan_masked(cls, array: Array) -> "Constraint":
        """Builds a constraint from an array in which NaN marks
        *unconstrained* positions."""
        array = np.asarray(array, dtype=float)
        mask = ~np.isnan(array)
        return cls(np.where(mask, array, 0.0), mask)

    def __repr__(self):
        return f"Constraint(shape={self.shape})"


def apply_constraints_along_last_axis(
    constraint: Optional[Constraint], array: Array
) -> torch.Tensor:
    """Applies an optional constraint spanning the full last axis;
    ``None`` is an explicit no-op so ODE paths can share code with PDE
    paths."""
    array = torch.as_tensor(array)
    if constraint is None:
        return array
    return constraint.apply(array)
