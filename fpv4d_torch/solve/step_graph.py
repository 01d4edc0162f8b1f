"""The phase program: each optimization phase's step captured once as a
CUDA graph and replayed for the rest of the phase.

The counterpart of the JAX package's one jitted ``lax.scan`` per phase:
``ClipSolver._run_phase`` (fpv4d/solve/clip_solve.py:639-714),
``_make_dct_only_phase`` (:716-762), ``phase_step_body`` (:764-841) and
``_run_skate_phase`` (:843-877); for the fleet, ``build_sharded_step``
and ``phase_scan`` (fpv4d/parallel/sharding.py:187-372; on a frames
mesh, the segments between a rank's collectives) and
``MultiClipSolver._get_step`` (fpv4d/parallel/multi_clip.py:69); for the
stages ahead of the clip solve, the keypoint fit's ``run_stage``
(fpv4d/solve/keypoint_fit.py:313-327), its ``run_stage_lbfgs_joint`` and
``run_stage_lbfgs_perframe`` (:343-414, each a jitted scan of optax's
L-BFGS with ``lax.while_loop`` line searches) and the smoothers' scans
over frames (fpv4d/solve/frame_fit.py:57-176); between a phase's
chunks, the jitted ``_refresh_cands``, ``_refresh_sdf`` and
``detect_contact`` (fpv4d/solve/clip_solve.py:403-424, 432-446,
480-502) and the fleet's ``build_sharded_refresh``,
``build_sharded_sdf_refresh`` and ``build_sharded_detect_contact``
(fpv4d/parallel/sharding.py:375-560).

A step (solve/clip_solve.py ``ClipSolver._run_steps``) zeroes the
gradients in place, computes the masked loss, runs the backward, takes
the Adam step (solve/adam.py) and returns the loss. A step may also
hold several optimizer steps and its own bookkeeping: a smoother's
frame body (solve/frame_fit.py) runs a frame's Adam steps, reading its
frame index from a device counter that it advances, so each replay
fits the next frame. ``PhaseProgram.run`` runs a phase's steps:

* on the graph route, the first WARMUP_STEPS steps of a key (over its
  runs, should a chunk be shorter) run eagerly on a side stream (real
  steps of the phase: their losses go into its history); then one step
  is captured with ``torch.cuda.graph``, which
  records and runs nothing, and the graph is replayed for the remaining
  steps, each replay's loss copied from the graph's static output into
  the phase's history on the device. Later runs of the same key (the
  next chunk of a phase whose candidate tables are refreshed between
  chunks, or the same phase of a later fit on a program that a
  ``ClipSolver`` keeps) replay the graph from their first step. Every
  graph of one program shares one memory pool and one side stream,
  released by ``close``;
* on the eager route (the CPU, and the card when asked), the same step
  runs ``num_steps`` times.

``PhaseProgram.call`` runs one call of a function the same way (its
first WARMUP_STEPS calls eager, then a capture and replays): an L-BFGS
iteration (solve/lbfgs.py) is five such pieces, and its line search's
rounds replay one of them while ``PhaseProgram.gate`` reads a
one-element device flag between replays. The torch this targets
(2.11) has no conditional graph nodes, so the host reads the flag
there; the rounds cost one device evaluation each, so the read's
round trip is small beside them. On a stand-in capture (a graph route
off the card, in the tests) the gate runs every round up to the cap.
``PhaseProgram.refresh`` runs a pure function of the program's buffers
(a contact refresh, an SDF linearization, a planted-foot detection):
its first call runs it eagerly as a warm-up and drops the result,
keeps copies of its outputs, captures it writing into them and replays
it; those copies are what ``stage`` hands the phase's step, so the
refresh writes the tables straight into the buffers the step reads.

``PhaseProgram.segment`` runs a differentiable piece of a step whose
collectives sit between its pieces (a frames rank's step,
parallel/sharding.py): an autograd function whose forward and backward
are each captured once per key and replayed, the partial-network
capture of ``torch.cuda.make_graphed_callables``, so autograd chains
its backward with the eager code around it (a collective's
``autograd.Function``, another segment). Its first WARMUP_STEPS calls
run eagerly on the side stream; the next captures the forward (into
the program's one pool) at its call and the backward at the call of
its backward, so segments are captured in the order their graphs are
replayed and a later capture reuses no memory an earlier graph still
needs. On every route the segment's backward is a ``torch.autograd.grad``
of its outputs to its inputs, run eagerly or replayed, so the eager and
graph routes sum a gradient's parts in the same order. An input at a
new address (a collective's output, new every step) is copied into the
buffer the graphs read; an input at the captured address (a leaf, a
staged table) is not.

A graph reads its inputs at the addresses it was captured on. Inputs
that change between runs of one key go through ``stage``: a captured
refresh's tables are already in its buffers, and any other value
(dct_a's hoisted joints, tables made outside the program) is copied
into the buffers of the first; everything else a step reads (the
leaves, the Adam state, targets, weights, scenes, grids) is fixed for
the life of the program. A program lives for one call of its caller,
except a ``ClipSolver``'s: its fits copy their leaves, targets and
weights into the buffers the kept graphs read and zero the Adam state
in place (solve/clip_solve.py). A failed capture or replay raises:
there is no fallback to the eager route.

With tracing on (utils/observability.py) a capture is a span
``capture/<phase>``, a refresh a span ``refresh/<phase>`` and a ``call``'s
eager warm-up a span ``warmup/<phase>`` (the key's first element), and
each replay of a ``call`` adds one to the counter ``replays/<phase>``.
The counters made where the step's code runs (each kernel's route,
``k1/cuda`` and the like) are not made by a replay, which runs no
Python: a capture keeps what the step counted apart (the capture
launches nothing), with tracing on or off, and each replay adds it while
tracing is on; so a graph captured untraced and replayed traced counts
as one captured traced does.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Hashable, Optional, Sequence

import torch

from fpv4d_torch.utils import observability as OBS

# eager steps of a key before its capture (cuBLAS handles and
# workspaces, the model's per-subset tables and the DCT basis are made
# there, never inside a capture)
WARMUP_STEPS = 2


class CudaGraphStep:
    """`step` captured as a CUDA graph on `stream` into the memory pool
    `pool`; ``out`` is the captured step's output, which every
    ``replay()`` rewrites."""

    def __init__(self, step: Callable[[], torch.Tensor], pool, stream):
        self.graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a collected cycle that
        # holds an earlier program's graph resets it, and a reset while a
        # stream captures invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.out = step()
        finally:
            if collecting:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()


def _as_tuple(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _copy_in(held: Sequence[torch.Tensor], given: Sequence[torch.Tensor],
             key: Hashable) -> None:
    """Each given tensor into the buffer a graph reads, unless it is that
    buffer's address already."""
    with torch.no_grad():
        for h, x in zip(held, given):
            if h.shape != x.shape:
                raise ValueError(f"segment {key}: a tensor of shape "
                                 f"{tuple(x.shape)} where the graph reads "
                                 f"{tuple(h.shape)}")
            if h.data_ptr() != x.data_ptr():
                h.copy_(x)


def _inputs(inputs, needs) -> tuple:
    """A segment's inputs as the leaves its function runs on: aliases,
    each needing a gradient where the segment's input does."""
    return tuple(x.detach().requires_grad_(n) for x, n in zip(inputs, needs))


def _input_grads(outs: tuple, diff: tuple, ins: tuple, grads: tuple
                 ) -> tuple:
    """The gradients of a segment's inputs from its outputs' (None for an
    input that needs none or that no output reaches)."""
    got = iter(torch.autograd.grad(
        [o for o, d in zip(outs, diff) if d],
        [x for x in ins if x.requires_grad],
        [g for g, d in zip(grads, diff) if d], allow_unused=True))
    return tuple(next(got) if x.requires_grad else None for x in ins)


class _EagerSegment:
    """One call of a segment's function under autograd, its backward a
    torch.autograd.grad of its outputs: the eager route, and a graph
    route's warm-up (run through `side`, the program's side stream)."""

    def __init__(self, fn: Callable, side: Optional[Callable] = None):
        self.fn = fn
        self.side = side or (lambda f: f())

    def forward(self, inputs, needs) -> tuple:
        self.ins = _inputs(inputs, needs)

        def run():
            with torch.enable_grad():
                return self.fn(*self.ins)

        out = self.side(run)
        self.single = not isinstance(out, (tuple, list))
        self.outs = _as_tuple(out)
        self.diff = tuple(o.requires_grad for o in self.outs)
        return self.outs

    def backward(self, grads) -> tuple:
        return self.side(lambda: _input_grads(self.outs, self.diff, self.ins,
                                              grads))


class _CapturedSegment:
    """A segment's forward, captured by `program` at its first call under
    `key` + ("forward",), and its backward, captured at the first call of
    its backward under `key` + ("backward",); each replayed afterwards.
    The inputs at that first call are the buffers its graphs read."""

    def __init__(self, program: "PhaseProgram", key: Hashable,
                 fn: Callable):
        self.program, self.key, self.fn = program, key, fn
        self.fwd = self.bwd = None

    def forward(self, inputs, needs) -> tuple:
        if self.fwd is not None:
            _copy_in(self.ins, inputs, self.key)
            return self.program._replay(self.fwd)
        self.ins = _inputs(inputs, needs)

        def step():
            with torch.enable_grad():
                out = self.fn(*self.ins)
            self.single = not isinstance(out, (tuple, list))
            return _as_tuple(out)

        self.fwd = self.program._capture(self.key + ("forward",), step)
        outs = self.program._replay(self.fwd)
        self.diff = tuple(o.requires_grad for o in outs)
        return outs

    def backward(self, grads) -> tuple:
        if self.bwd is not None:
            _copy_in([g for g in self.grads if g is not None],
                     [g for g, d in zip(grads, self.diff) if d], self.key)
            return self.program._replay(self.bwd)
        self.grads = tuple(
            g.detach().clone(memory_format=torch.contiguous_format)
            if d else None for g, d in zip(grads, self.diff))
        graph = self.fwd[0]
        self.bwd = self.program._capture(
            self.key + ("backward",),
            lambda: _input_grads(graph.out, self.diff, self.ins, self.grads))
        return self.program._replay(self.bwd)


class _Segment(torch.autograd.Function):
    """A segment on the autograd tape: its forward and backward are its
    runner's (_EagerSegment or _CapturedSegment), whose outputs are
    handed on as aliases."""

    @staticmethod
    def forward(ctx, runner, *inputs):
        ctx.runner = runner
        outs = tuple(o.detach() for o in runner.forward(
            inputs, ctx.needs_input_grad[1:]))
        ctx.mark_non_differentiable(*(o for o, d in zip(outs, runner.diff)
                                      if not d))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(None if g is None else g.detach()
                               for g in ctx.runner.backward(grads))


class PhaseProgram:
    """The phases of the fits it serves on `device`: captured and
    replayed (`graphs`, CUDA only) or eager. `make_graph(step, pool,
    stream)` captures a step (CudaGraphStep; the tests pass a
    stand-in)."""

    def __init__(self, device, graphs: bool,
                 make_graph: Callable = CudaGraphStep):
        self.device = torch.device(device)
        if graphs and make_graph is CudaGraphStep \
                and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{self.device}")
        self.graphs = graphs
        self._make_graph = make_graph
        on_card = graphs and self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if on_card else None
        self.stream = torch.cuda.Stream(self.device) if on_card else None
        self._steps: Dict[Hashable, tuple] = {}
        self._warm: Dict[Hashable, int] = {}
        self._static: Dict[Hashable, tuple] = {}
        self._segments: Dict[Hashable, _CapturedSegment] = {}
        # host seconds of each key's capture
        self.capture_seconds: Dict[Hashable, float] = {}

    def stage(self, key: Hashable, tensors: Sequence[torch.Tensor]
              ) -> tuple:
        """`tensors` as a graph of this program reads them: on the graph
        route, the first call's copies, into which every later call of
        `key` copies its values; on the eager route, the tensors."""
        if not self.graphs:
            return tuple(tensors)
        held = self._static.get(key)
        with torch.no_grad():
            if held is None:
                held = tuple(t.detach().clone() for t in tensors)
                self._static[key] = held
            else:
                for h, t in zip(held, tensors):
                    if h is not t:
                        h.copy_(t)
        return held

    def run(self, key: Hashable, step: Callable[[], torch.Tensor],
            num_steps: int) -> torch.Tensor:
        """num_steps steps of `step` (which returns the step's detached
        loss), each a ``call`` of `key` -> the losses [num_steps, ...] on
        the device."""
        return self.loop(lambda: self.call(key, step), num_steps)

    def loop(self, step: Callable[[], torch.Tensor],
             num_steps: int) -> torch.Tensor:
        """num_steps calls of `step`, which returns the step's detached
        loss, each run as it is (a step whose pieces go through the
        program) -> the losses [num_steps, ...] on the device."""
        if num_steps <= 0:
            return torch.empty(0, dtype=torch.float32, device=self.device)
        hist = None
        for i in range(num_steps):
            loss = step()
            if hist is None:
                hist = torch.empty((num_steps,) + loss.shape,
                                   dtype=torch.float32, device=loss.device)
            hist[i].copy_(loss)
        return hist

    def call(self, key: Hashable, fn: Callable):
        """One call of `fn`, a step or a piece of one that updates the
        program's buffers in place -> its output (on the graph route, the
        captured output that each replay rewrites). On the graph route
        the first WARMUP_STEPS calls of a key run eagerly on the side
        stream (real calls), the next is captured and replayed, and every
        later call replays."""
        if not self.graphs:
            return fn()
        captured = self._steps.get(key)
        if captured is None:
            warm = self._warm.get(key, 0)
            if warm < WARMUP_STEPS:
                self._warm[key] = warm + 1
                with OBS.span(f"warmup/{key[0]}"):
                    return self._side(fn)
            captured = self._capture(key, fn)
        if OBS.spans_on:
            OBS.count(f"replays/{key[0]}")
        return self._replay(captured)

    def segment(self, key: Hashable, fn: Callable, *inputs: torch.Tensor):
        """fn(*inputs), differentiable in its inputs, as a piece of a step
        (its other tensors the program's fixed buffers) -> fn's output, a
        tensor or a tuple of them (aliases of the captured outputs on the
        graph route, valid until the key's next call). Eagerly, fn under
        autograd, its backward a torch.autograd.grad of its outputs to its
        inputs. On the graph route the first WARMUP_STEPS calls of a key
        run that way on the side stream; the next captures the forward,
        and its backward captures the backward; every later call replays
        them, copying an input at a new address into the captured one's
        buffer."""
        if not self.graphs:
            runner = _EagerSegment(fn)
        else:
            runner = self._segments.get(key)
            if runner is None:
                warm = self._warm.get(key, 0)
                if warm < WARMUP_STEPS:
                    self._warm[key] = warm + 1
                    runner = _EagerSegment(fn, self._side)
                else:
                    runner = _CapturedSegment(self, key, fn)
                    self._segments[key] = runner
        outs = _Segment.apply(runner, *inputs)
        return outs[0] if runner.single else outs

    def refresh(self, key: Hashable,
                fn: Callable[[Optional[tuple]], tuple]) -> tuple:
        """A function of the program's buffers that writes nothing else
        (a contact refresh, a detection): `fn(out)` returns its tensors,
        written into `out` when given (else new ones). Eagerly, fn(None).
        On the graph route the first call runs fn(None) eagerly on the
        side stream as a warm-up (its result dropped), keeps copies of
        its tensors under `key` (what ``stage(key, ...)`` hands a step),
        captures fn(copies) and replays it; every later call replays.
        Returns the captured function's outputs: the kept copies where
        fn writes into `out`, which ``stage`` then does not copy."""
        with OBS.span(f"refresh/{key[0]}"):
            if not self.graphs:
                return fn(None)
            captured = self._steps.get(key)
            if captured is None:
                with torch.no_grad():
                    held = tuple(t.detach().clone()
                                 for t in self._side(lambda: fn(None)))
                self._static[key] = held
                captured = self._capture(key, lambda: fn(held))
            return self._replay(captured)

    def gate(self, pred: torch.Tensor) -> bool:
        """Whether a gated piece (a line-search round, a re-evaluation)
        runs: a host read of the one-element device flag `pred` (the
        eager route, and the card's graph route between replays), or
        always on a stand-in capture (a graph route off the card), where
        a piece that finds nothing to do changes nothing."""
        if self.graphs and self.device.type != "cuda":
            return True
        return bool(pred)

    def _replay(self, captured):
        graph, per_step = captured
        graph.replay()
        for name, n in per_step.items():
            OBS.count(name, n)
        return graph.out

    def _side(self, step: Callable[[], torch.Tensor]) -> torch.Tensor:
        """One eager step on the side stream, ordered after everything
        queued on the current stream and before what follows there."""
        if self.stream is None:
            return step()
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = step()
        main.wait_stream(self.stream)
        return out

    def _capture(self, key: Hashable, step: Callable):
        t0 = time.perf_counter()
        with OBS.span(f"capture/{key[0]}"), OBS.counted_apart() as per_step:
            graph = self._make_graph(step, self.pool, self.stream)
        self.capture_seconds[key] = time.perf_counter() - t0
        self._steps[key] = (graph, per_step)
        return graph, per_step

    def close(self) -> None:
        """Drop the graphs and the staged buffers (their memory pool goes
        with the last reference to it)."""
        self._steps.clear()
        self._segments.clear()
        self._warm.clear()
        self._static.clear()
        self.pool = None


def eager(device) -> PhaseProgram:
    """A program that runs every step eagerly."""
    return PhaseProgram(device, graphs=False)


def use_graphs(device, step_graphs: Optional[bool]) -> bool:
    """The route an entry point's `step_graphs` argument takes on
    `device`: None captures on a CUDA device and runs eagerly elsewhere,
    False runs eagerly on either, True captures and raises on a device
    that cannot."""
    on_card = torch.device(device).type == "cuda"
    if step_graphs and not on_card:
        raise ValueError(f"step_graphs=True needs a CUDA device, not "
                         f"{device}")
    return on_card if step_graphs is None else bool(step_graphs)
