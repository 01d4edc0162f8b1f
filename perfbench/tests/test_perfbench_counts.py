"""The yardstick's arithmetic: the contact kernels' least times at the
shapes of the port's kernel table (PERF.md, the "bound ms" column), and
the FLOP count of the plain objective against one written out from the
layer widths."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.counts import bounds
from perfbench.reference.body import vposer_decode

# (function, shape, bound ms as PERF.md's kernel table gives it, bound)
TABLE = [
    (bounds.k1_bound_ms, (900, 813, 192), 0.0077, "bytes"),
    (bounds.k1_bound_ms, (900, 813, 512), 0.0112, "operations"),
    (bounds.k1_bound_ms, (900, 870, 512), 0.0120, "operations"),
    (bounds.k1_bound_ms, (7200, 813, 192), 0.0613, "bytes"),
    (bounds.k1_bound_ms, (450, 813, 192), 0.0038, "bytes"),
    (bounds.k2_bound_ms, (731_700, 100_489), 2.1979, "operations"),
    (bounds.k2_bound_ms, (64 * 896, 4096), 0.0070, "operations"),
    (bounds.k2_bound_ms, (731_700, 100_489, 2), 4.3957, "operations"),
    (bounds.k2_bound_ms, (365_850, 100_489), 1.0989, "operations"),
]


@pytest.mark.parametrize("fn,shape,ms,kind", TABLE)
def test_kernel_bounds_match_the_table(fn, shape, ms, kind):
    got, which = fn(*shape)
    assert which == kind
    assert round(got, 4) == ms


def test_vposer_decode_flops_from_widths():
    T, L, H, J = 900, 32, 512, 21
    g = torch.Generator().manual_seed(3)
    w = {"w1": torch.randn(L, H, generator=g), "b1": torch.zeros(H),
         "w2": torch.randn(H, H, generator=g), "b2": torch.zeros(H),
         "w3": torch.randn(H, J * 6, generator=g), "b3": torch.zeros(J * 6)}
    z = torch.randn(T, L, generator=g)
    with FlopCounterMode(display=False) as fc:
        vposer_decode(w, z)
    by_hand = 2 * T * (L * H + H * H + H * J * 6)
    assert fc.get_total_flops() == by_hand


def test_pairs_count_two_flops():
    from perfbench.counts import flops
    assert flops.FLOPS_PER_PAIR == 2
