"""K1 (fpv4d_torch/csrc/cand_nn.cu) and its wrapper.

On the CPU the wrapper takes the plain version, and only because the
tensors lie on the CPU; the kernel itself runs only on a CUDA card:
those tests carry the `gpu` marker and skip here (see README, "PyTorch
port (H100)", for the command that runs them on the card). On the card
the kernel is held bit-exactly against the plain version: its
tensor-core filter only chooses which candidates to re-evaluate, and
each re-evaluation is the plain version's difference form without FMA
contraction, so no tolerance is needed."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fpv4d_torch.ops import cand_cuda as C
from fpv4d_torch.utils import observability as OBS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    return torch.device("cuda")


def _inputs(T=7, N=300, P=192, seed=0, device="cpu"):
    rng = np.random.RandomState(seed)
    q = rng.randn(T, N, 3).astype(np.float32)
    cand = rng.randn(T, P, 3).astype(np.float32)
    valid = rng.rand(T, P) > 0.3
    valid[3] = False                          # an empty frame
    cand[:, 1] = cand[:, 0]                   # duplicate candidates
    return (torch.as_tensor(q, device=device),
            torch.as_tensor(cand, device=device),
            torch.as_tensor(valid, device=device))


def _launches(fn):
    """fn() under tracing -> (its result, K1's launches counted)."""
    OBS.reset_counts()
    with OBS.tracing():
        out = fn()
        n = OBS.counts().get("k1/cuda", 0)
    OBS.reset_counts()
    return out, n


def test_route_counters_name_the_plain_version_on_the_cpu():
    """cand_nn counts k1/plain for CPU tensors while tracing is on, and
    nothing while it is off."""
    q, cand, valid = _inputs(T=5, N=20, P=16)
    OBS.reset_counts()
    C.cand_nn(q, cand, valid)
    assert OBS.counts() == {}
    with OBS.tracing():
        C.cand_nn(q, cand, valid)
        C.nn_to_candidates(q, cand, valid)
        counts = OBS.counts()
    OBS.reset_counts()
    assert counts == {"k1/plain": 2}


def test_cpu_tensors_take_plain_version():
    q, cand, valid = _inputs()
    (d, slot, near), n = _launches(lambda: C.cand_nn(q, cand, valid))
    d_p, s_p, n_p = C.cand_nn_plain(q, cand, valid)
    assert n == 0                             # no kernel launch counted
    assert torch.equal(d, d_p) and torch.equal(slot, s_p)
    assert torch.equal(near, n_p)
    assert slot.dtype == torch.int32 and d.shape == (7, 300)
    assert torch.all(d[3] == C.BIG) and torch.equal(near[3], q[3])


def test_plain_version_ties_to_smallest_slot():
    q = torch.zeros(1, 2, 3)
    cand = torch.zeros(1, 5, 3)
    cand[0, :, 0] = torch.tensor([3.0, 1.0, 1.0, -1.0, 2.0])
    valid = torch.tensor([[True, True, True, True, True]])
    _, slot, _ = C.cand_nn_plain(q, cand, valid)
    assert slot.tolist() == [[1, 1]]          # 1 and 2 and 3 tie at d=1


def test_kernel_wrapper_rejects_cpu_tensors():
    q, cand, valid = _inputs()
    with pytest.raises(ValueError):
        C.cand_nn_cuda(q, cand, valid)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [192, 512, 700])
def test_kernel_matches_plain_bit_exactly(cuda_device, P):
    q, cand, valid = _inputs(P=P, device=cuda_device)
    (d_k, s_k, n_k), n = _launches(lambda: C.cand_nn_cuda(q, cand, valid))
    d_p, s_p, n_p = C.cand_nn_plain(q, cand, valid)
    assert n == 1
    assert torch.equal(d_k, d_p) and torch.equal(s_k, s_p)
    assert torch.equal(n_k, n_p)
    qk = q.clone().requires_grad_(True)
    qp = q.clone().requires_grad_(True)
    C.nn_to_candidates(qk, cand, valid).sum().backward()
    C.nn_to_candidates_ref(qp, cand, valid).sum().backward()
    assert torch.equal(qk.grad, qp.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("T,N", [(70_000, 32), (65_536, 129)])
def test_kernel_beyond_65535_frames(cuda_device, T, N):
    """Folded fleets reach 73 clips of 900 frames: more frames than a
    grid's y axis takes. One launch, bit-exact against the plain version
    (the last frame included)."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.randn((T, N, 3), device=cuda_device, generator=gen)
    cand = torch.randn((T, 192, 3), device=cuda_device, generator=gen)
    valid = torch.rand((T, 192), device=cuda_device, generator=gen) > 0.3
    valid[-1] = False
    (d_k, s_k, n_k), n = _launches(lambda: C.cand_nn_cuda(q, cand, valid))
    assert n == 1
    d_p, s_p, n_p = C.cand_nn_plain(q, cand, valid)
    assert torch.equal(d_k, d_p) and torch.equal(s_k, s_p)
    assert torch.equal(n_k, n_p)
    assert bool((d_k[-1] == C.BIG).all())


def _near_tie_case(name, device):
    q, cand, valid = _inputs(P=192)
    if name == "sphere, 1 ulp":
        rng = np.random.RandomState(5)
        u = rng.randn(7, 192, 3)
        u /= np.linalg.norm(u, axis=2, keepdims=True)
        c = (q[:, :1].numpy() + 0.2 * u).astype(np.float32)
        c[:, ::2, 2] = np.nextafter(c[:, ::2, 2], np.float32(np.inf))
        cand = torch.as_tensor(c)
        valid = torch.ones(7, 192, dtype=torch.bool)
    elif name == "near +-1000":
        q = q + 1000.0
        cand[:, ::2] += 1000.0
        cand[:, 1::2] -= 1000.0
    elif name == "N = 1":
        q = q[:, :1].contiguous()
    elif name == "every slot invalid but one":
        valid[:] = False
        valid[:, 100] = True
    return (q.to(device), cand.to(device), valid.to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["sphere, 1 ulp", "near +-1000", "N = 1",
                                  "every slot invalid but one"])
def test_kernel_matches_plain_on_near_ties(cuda_device, case):
    q, cand, valid = _near_tie_case(case, cuda_device)
    rechecks = torch.zeros(q.shape[:2], dtype=torch.int32,
                           device=cuda_device)
    d_k, s_k, n_k = C.cand_nn_cuda(q, cand, valid, rechecks=rechecks)
    d_p, s_p, n_p = C.cand_nn_plain(q, cand, valid)
    assert torch.equal(d_k, d_p) and torch.equal(s_k, s_p)
    assert torch.equal(n_k, n_p)
    assert bool((rechecks >= 1).all())        # every winner is re-checked
    d_n, s_n, n_n = C.cand_nn_cuda(q, cand, valid)
    assert torch.equal(d_n, d_k) and torch.equal(s_n, s_k)


@pytest.mark.gpu
def test_rechecks_must_fit_the_queries(cuda_device):
    q, cand, valid = _inputs(device=cuda_device)
    with pytest.raises(ValueError):
        C.cand_nn_cuda(q, cand, valid,
                       rechecks=torch.zeros(3, dtype=torch.int32,
                                            device=cuda_device))


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py exits non-zero and prints no result when no CUDA
    device is available."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, str(root / "chip_smoke.py")],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
