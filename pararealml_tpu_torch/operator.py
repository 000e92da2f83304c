"""The solver-operator interface.

Port of the JAX package's ``operator.py``: the :class:`Operator` base
class, ``discretize_time_domain``, and :class:`TorchOperator`, the
counterpart of the JAX package's ``JaxOperator`` contract. Operators that
expose their solve as a function from the initial state to the full
trajectory (and, optionally, to the end state only) let the Parareal
operator compose fine and coarse solvers with slices batched along a
leading tensor axis.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from pararealml_tpu_torch.initial_value_problem import (
    InitialValueProblem,
    TemporalDomainInterval,
)
from pararealml_tpu_torch.solution import Solution
from pararealml_tpu_torch.utils import tracing


class Operator:
    """Base class for solvers of initial value problems over a time
    interval with a fixed output step size.

    ``dtype`` and ``device`` select where :meth:`solve` places the
    initial state. ``device=None`` means the CUDA card: the port's entry
    points run on the card unless the caller asks for another device
    (the CPU tests pass ``device="cpu"``), and on a host without one a
    solve fails when it first touches CUDA. ``dtype=None`` means torch's
    default dtype. Functions that take a state tensor follow the state's
    device.
    """

    def __init__(
        self,
        d_t: float,
        vertex_oriented: Optional[bool],
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        if d_t <= 0.0:
            raise ValueError("time step size must be greater than 0")
        self._d_t = d_t
        self._vertex_oriented = vertex_oriented
        self._device = device
        self._dtype = dtype

    @property
    def d_t(self) -> float:
        """The temporal step size of the operator."""
        return self._d_t

    @property
    def vertex_oriented(self) -> Optional[bool]:
        """Whether solutions are evaluated at mesh vertices or cell
        centers (None for pure ODE solvers)."""
        return self._vertex_oriented

    @property
    def device(self) -> torch.device:
        """The device :meth:`solve` places the initial state on (the
        CUDA card unless one was given)."""
        if self._device is None:
            return torch.device("cuda")
        return torch.device(self._device)

    @property
    def dtype(self) -> torch.dtype:
        """The floating-point type of the solver state."""
        if self._dtype is None:
            return torch.get_default_dtype()
        return self._dtype

    def solve(
        self, ivp: InitialValueProblem, parallel_enabled: bool = True
    ) -> Solution:
        """Solves the IVP and returns its :class:`Solution`."""
        raise NotImplementedError


class TorchOperator(Operator):
    """An operator whose solve is expressible as a function from the
    initial state to the full trajectory.

    This is the contract that lets the Parareal operator compose fine and
    coarse solvers over a batch of time slices.
    """

    def trajectory_function(
        self,
        cp,
        t_interval: TemporalDomainInterval,
        allow_fused: bool = True,
        time_parallel: bool = False,
        dtype: Optional[torch.dtype] = None,
        device=None,
        batch: Optional[int] = None,
    ) -> Tuple[Callable[..., torch.Tensor], np.ndarray]:
        """Returns ``(fn, t_coordinates)`` where ``fn(y_0, t_0)`` maps
        the initial state (``y_shape``, optionally with leading batch
        axes ``lead``) and the interval start time to the trajectory of
        shape ``lead + (len(t_coordinates),) + y_shape``.

        ``t_coordinates`` are the output times relative to
        ``t_interval[0]`` (excluding the initial time).

        The function carries tags callers dispatch on: ``vmappable``
        (any leading batch axes are mapped elementwise on the generic
        path), ``fused`` (a hand-written kernel runs it), ``batched``
        (it takes exactly ``batch`` states), ``end_function`` and
        ``affine_slice_map`` (affine propagators).

        :param allow_fused: whether hand-written kernels may be used
        :param time_parallel: whether the caller is a parallel-in-time
            composition (Parareal), in which case the operator may use
            trajectory formulations that are parallel across time steps
            (affine propagator matmuls,
            :mod:`pararealml_tpu_torch.ops.linear_propagator`)
        :param dtype: the state's floating-point type (defaults to the
            operator's); it selects between the generic path and the
            float32 kernels
        :param device: where constant tensors the function holds (such
            as propagator matrices) are built (defaults to the
            operator's); a state on another device wins, and the
            constants follow it
        :param batch: the number of states the caller stacks along one
            leading axis (Parareal's slices), or None; the operator may
            then return a function of exactly that batch (tagged
            ``batched``), such as a kernel that runs the states side by
            side, and otherwise ignores it
        """
        raise NotImplementedError

    def ends_function(
        self,
        cp,
        t_interval: TemporalDomainInterval,
        allow_fused: bool = True,
        batch: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> Optional[Callable[..., torch.Tensor]]:
        """An ends-only solver ``fn(y_0, t_0) -> y_end`` for the interval,
        tagged as :meth:`trajectory_function`'s functions are, with
        ``batch`` meaning what it means there; or None (the default),
        in which case callers take the trajectory's last frame."""
        return None


def discretize_time_domain(
    t: TemporalDomainInterval, d_t: float
) -> np.ndarray:
    """Discretizes a time interval into whole steps of size ``d_t``
    (rounding the step count), returning ``steps + 1`` points."""
    t_0 = float(t[0])
    steps = int(round((t[1] - t_0) / d_t))
    return np.linspace(t_0, t_0 + steps * d_t, steps + 1)


# the most float64 bytes of frames that cross to the host as one piece
# while their kernel still runs (PERF.md, section 6, measured on the card)
CHUNK_BYTES = 8 << 20


def trajectory_chunks(frame_bytes: int, steps: int) -> List[Tuple[int, int]]:
    """The pieces ``[start, end)`` in which a trajectory of ``steps``
    frames of ``frame_bytes`` float64 bytes each crosses to the host:
    pieces of the most frames, a power of two, whose bytes stay within
    :data:`CHUNK_BYTES`, in order, the last ending at ``steps``; one piece
    for a trajectory of fewer than two such pieces."""
    frames = 1
    while 2 * frames * frame_bytes <= CHUNK_BYTES:
        frames *= 2
    if frame_bytes > CHUNK_BYTES or steps < 2 * frames:
        return [(0, steps)]
    return [
        (start, min(start + frames, steps))
        for start in range(0, steps, frames)
    ]


class FrameProgress:
    """How far a trajectory kernel of one state on the card has got: the
    int32 device word of ``drain`` that it stores its count of finished
    frames to at the end of each of ``chunks`` (:func:`trajectory_chunks`),
    every ``chunk`` frames and at its last step (``csrc/progress.cuh``).
    :meth:`FrameDrain.progress` makes one; the trajectory functions
    tagged ``publishes`` take it as ``progress=``, and
    :func:`materialize_solution` copies each piece out as it is done."""

    def __init__(self, drain: "FrameDrain", chunks: List[Tuple[int, int]]):
        self.drain = drain
        self.chunks = chunks

    @property
    def word(self) -> torch.Tensor:
        return self.drain.word

    @property
    def chunk(self) -> int:
        """The frames of every piece but the last."""
        return self.chunks[0][1]

    def launch_arguments(self, states: int) -> Tuple[int, int]:
        """The ``progress`` and ``chunk`` arguments of a kernel launch of
        ``states`` states; raises ValueError for more than one state:
        only a trajectory of one state publishes."""
        if states != 1:
            raise ValueError(
                f"a trajectory of {states} states publishes no progress"
            )
        return self.word.data_ptr(), self.chunk

    def publish_all(self, states: int, steps: int):
        """What a kernel's plain version publishes: all ``steps`` frames,
        once it has returned them."""
        self.launch_arguments(states)
        self.word.fill_(steps)


class FrameDrain:
    """What a trajectory needs on one card to cross to the host while its
    kernel runs: the progress word the kernel publishes to, the side
    stream that copies, the event after the word's reset, and a ring of
    two float64 slots of a piece each. An operator keeps one for the
    solves it runs one after another."""

    def __init__(self, device: torch.device):
        self.word = torch.zeros(1, dtype=torch.int32, device=device)
        self.stream = torch.cuda.Stream(device)
        self.reset = torch.cuda.Event()
        self.ring = torch.empty(0, dtype=torch.float64, device=device)

    @staticmethod
    def usable(device: torch.device) -> bool:
        """Whether ``device`` is a card whose streams can wait on a word."""
        from pararealml_tpu_torch.ops.cuda_library import stream_waits_usable

        if device.type != "cuda":
            return False
        if device.index is None:
            return stream_waits_usable(torch.cuda.current_device())
        return stream_waits_usable(device.index)

    def progress(
        self, frame_bytes: int, steps: int
    ) -> Optional[FrameProgress]:
        """A :class:`FrameProgress` for the next trajectory kernel
        launched on the card's current stream, whose ``steps`` frames
        widen to ``frame_bytes`` float64 bytes each, with the word reset
        to 0 on that stream; or None for a trajectory of one piece."""
        chunks = trajectory_chunks(frame_bytes, steps)
        if len(chunks) < 2:
            return None
        device = self.word.device
        with torch.cuda.device(device):
            self.word.zero_()
            self.reset.record(torch.cuda.current_stream(device))
        return FrameProgress(self, chunks)

    def ring_slots(self, values: int) -> torch.Tensor:
        """The ring as two slots of ``values`` float64 values each,
        grown on the side stream, which alone uses it."""
        if self.ring.numel() < 2 * values:
            with torch.cuda.stream(self.stream):
                self.ring = torch.empty(
                    2 * values, dtype=torch.float64, device=self.word.device
                )
        return self.ring[: 2 * values].view(2, values)


def materialize_solution(
    ivp: InitialValueProblem,
    t_coordinates: np.ndarray,
    ys: torch.Tensor,
    vertex_oriented: Optional[bool],
    d_t: float,
    progress: Optional[FrameProgress] = None,
) -> Solution:
    """The :class:`Solution` of a trajectory: ``ys`` in float64 on the
    host (span ``solve.to_host``), then the ``Solution`` built from it
    (span ``solution.build``).

    A trajectory on the card crosses to the host into page-locked memory
    from torch's caching host allocator (count ``to_host_pinned``), which
    the ``Solution`` adopts as its own array: the block returns to the
    allocator's cache when the ``Solution`` is freed. With the
    ``progress`` of the kernel that is still computing ``ys``, each of its
    pieces is widened on a side stream into a ring of two slots and
    copied out as soon as the kernel publishes it, so that only the last
    piece is left once the kernel ends (count ``to_host_chunks``, the
    pieces); without it the whole trajectory is widened on the card and
    copied once. Where the host cannot lock more memory, the trajectory
    lands in a new pageable array, adopted the same way. A trajectory on
    the CPU may be the operator's own tensor, so the ``Solution`` copies
    it."""
    with tracing.span("solve.to_host", bytes=ys.numel() * 8):
        on_host = ys.device.type == "cpu"
        if on_host:
            host = ys.to(torch.float64).numpy()
        else:
            host = _page_locked_copy(ys, progress)
    with tracing.span("solution.build"):
        build = Solution if on_host else Solution._adopt
        return build(
            ivp,
            t_coordinates,
            host,
            vertex_oriented=vertex_oriented,
            d_t=d_t,
        )


def _page_locked_copy(
    ys: torch.Tensor, progress: Optional[FrameProgress]
) -> np.ndarray:
    """A new float64 host copy of the device tensor ``ys``, in page-locked
    memory where the host can lock it and in pageable memory otherwise;
    complete when this returns. With ``progress``, piece by piece while
    the kernel runs."""
    try:
        host = torch.empty(ys.shape, dtype=torch.float64, pin_memory=True)
    except RuntimeError:
        return ys.to(torch.float64).cpu().numpy()
    if progress is None or not ys.is_contiguous():
        host.copy_(ys.to(torch.float64))
    else:
        _drain(ys, host, progress)
        tracing.count("to_host_chunks", len(progress.chunks))
    tracing.count("to_host_pinned", 1)
    return host.numpy()


def _drain(ys: torch.Tensor, host: torch.Tensor, progress: FrameProgress):
    """Copies the frames of ``ys`` (time first) into the page-locked
    ``host`` piece by piece on the card's side stream: each piece waits
    for the kernel to publish it, is widened into a ring slot and copied
    out; one stream orders each widening after the copy that last used
    its slot. Complete when this returns."""
    from pararealml_tpu_torch.ops.cuda_library import wait_at_least

    if progress.chunks[-1][1] != ys.shape[0]:
        raise ValueError(
            f"a plan of {progress.chunks[-1][1]} frames for a trajectory "
            f"of {ys.shape[0]}"
        )
    drain = progress.drain
    frames = ys.reshape(ys.shape[0], -1)
    pieces = host.view(frames.shape)
    slots = drain.ring_slots(progress.chunk * frames.shape[1])
    stream = drain.stream
    # after the word's reset: the previous solve's count is gone
    stream.wait_event(drain.reset)
    with torch.cuda.stream(stream):
        for k, (start, end) in enumerate(progress.chunks):
            wait_at_least(stream, drain.word, end)
            slot = slots[k % 2].view(-1, frames.shape[1])[: end - start]
            slot.copy_(frames[start:end])
            pieces[start:end].copy_(slot, non_blocking=True)
    stream.synchronize()
