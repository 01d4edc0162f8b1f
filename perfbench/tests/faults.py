"""Faults planted under the timed path, for the tests that see a broken
run come out not correct and for the readings of a fault at a cell's
size (``python3 -m perfbench.tests.readings --fault replay``)."""
from __future__ import annotations

import contextlib

import torch


class RerunCapture:
    """A stand-in for a CUDA graph off the card: the capture records
    nothing; each replay reruns the step, with ``replaying`` set."""

    replaying = False

    def __init__(self, step, pool, stream):
        self.step = step
        self.out = None

    def replay(self):
        RerunCapture.replaying = True
        try:
            self.out = self.step()
        finally:
            RerunCapture.replaying = False


def _in_replay() -> bool:
    """Whether the running Adam step is being captured (on the card: a
    replay runs what was captured) or replayed (the stand-in)."""
    on_card = (torch.cuda.is_available()
               and torch.cuda.is_current_stream_capturing())
    return on_card or RerunCapture.replaying


@contextlib.contextmanager
def replays_leave_the_state():
    """Every replayed step of the program runs no Adam update: its eager
    warm-up steps update the state, its graph's replays leave it as it
    is."""
    from fpv4d_torch.solve.adam import Adam
    orig = Adam.step

    def step(self):
        if not _in_replay():
            orig(self)

    Adam.step = step
    try:
        yield
    finally:
        Adam.step = orig


@contextlib.contextmanager
def graph_route_off_the_card():
    """Every solver's phase program takes the graph route on the CPU,
    with `RerunCapture` for a graph."""
    from fpv4d_torch.solve import step_graph
    from fpv4d_torch.solve.clip_solve import ClipSolver
    orig = ClipSolver.program

    def program(self):
        return step_graph.PhaseProgram(self.device, True, RerunCapture)

    ClipSolver.program = program
    try:
        yield
    finally:
        ClipSolver.program = orig
