"""K2 (fpv4d_torch/csrc/chamfer_nn.cu) and its wrapper; no jax, so the
file runs on the card too (README, "PyTorch port (H100)").

On the CPU the wrapper takes the plain version, and only because the
tensors lie on the CPU; the kernel itself runs only on a CUDA card:
those tests carry the `gpu` marker and skip here. On the card the
kernel is held bit-exactly against the plain version: its distance is
computed without FMA contraction, in the plain version's order, so no
tolerance is needed."""
import numpy as np
import pytest
import torch

from fpv4d_torch.ops import chamfer_cuda as K


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 has no CPU mode)")
    return torch.device("cuda")


def _clouds(N=100, M=777, seed=0, scale=1.0, B=2):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, N, 3) * scale).astype(np.float32)
    y = (rng.randn(M, 3) * scale).astype(np.float32)
    return x, y


def test_cpu_tensors_take_plain_version():
    x, y = _clouds(30, 64, 14)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    before = K.launches
    d, i = K.nn_index(xt, yt)
    d_p, i_p = K.nn_distance_plain(xt, yt)
    assert K.launches == before
    assert torch.equal(d, d_p) and torch.equal(i, i_p)


def test_kernel_wrapper_rejects_what_it_does_not_take():
    x, y = _clouds(5, 9, 15)
    with pytest.raises(ValueError):
        K.nn_distance_cuda(torch.as_tensor(x), torch.as_tensor(y))
    with pytest.raises(ValueError):
        K.nn_distance(torch.as_tensor(x), torch.zeros(0, 3))
    with pytest.raises(ValueError):
        K.nn_distance_plain(torch.as_tensor(x), torch.zeros(4, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("N,M,scale", [(813, 3001, 1.0), (1, 5, 1.0),
                                       (1000, 2049, 1.0), (129, 300, 40.0)])
def test_kernel_matches_plain_bit_exactly(cuda_device, N, M, scale):
    x, y = _clouds(N, M, 16, scale)
    y = np.concatenate([y, y[:M // 3]])       # duplicates
    n_eq = min(3, N)
    x[0, :n_eq] = y[:n_eq]                    # exact matches
    xt = torch.as_tensor(x, device=cuda_device)
    yt = torch.as_tensor(y, device=cuda_device)
    before = K.launches
    d_k, i_k = K.nn_distance_cuda(xt, yt)
    d_p, i_p = K.nn_distance_plain(xt, yt)
    assert K.launches == before + 1
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    xk = xt.clone().requires_grad_(True)
    xp = xt.clone().requires_grad_(True)
    K.nn_distance(xk, yt)[0].sum().backward()
    K.nn_distance_ref(xp, yt)[0].sum().backward()
    assert torch.equal(xk.grad, xp.grad)
