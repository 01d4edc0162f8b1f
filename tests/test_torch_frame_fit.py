"""Port parity of the per-frame smoother (fpv4d_torch/solve/frame_fit.py)
and the GRU motion prior (fpv4d_torch/models/motion_gru.py) against the
JAX package on the same seeded clip (tests/test_frame_fit.py's recipe:
T=8, smooth noise plus 0.1 per-frame jitter), on the CPU.

Tolerances: the GRU forward rtol 1e-5 / atol 1e-6 (f32 matmul order);
the stand-in weights bit-identical. The smoothers: every frame's first
Adam step starts at an exact zero of the L1 reconstruction term, where
the port's |x| has JAX's derivative (+1), so the first steps agree to
f32 rounding (atol 5e-6 after one step per frame; measured 6.0e-8 on
the optax-order Adam of solve/adam.py, 1.0e-6 on torch.optim.Adam
before it); after 30 steps (sequential: 240 on one Adam state) the
results agree to atol 1e-4 (measured 1.2e-7 independent, 2.1e-7
sequential, 2.7e-7 motion; 3.3e-7, 3.4e-6 and 3.2e-6 on torch.optim's
Adam), the L1 terms' sign changes near zero residuals being where the
two roundings can part (each such step is at most lr = 0.1; none is met
here)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fpv4d.config import FrameFitConfig as JConfig
from fpv4d.models import motion_gru as JGRU
from fpv4d.solve import frame_fit as JFF
from fpv4d_torch import convert
from fpv4d_torch.config import FrameFitConfig as TConfig
from fpv4d_torch.models import motion_gru as TGRU
from fpv4d_torch.ops import losses
from fpv4d_torch.solve import frame_fit as TFF

from helpers import smooth_noise

T = 8
ITERS = 30


@pytest.fixture(scope="module")
def clip():
    rng = np.random.RandomState(0)
    body = np.zeros((T, 75), dtype=np.float32)
    body[:, 0:3] = smooth_noise(T, 3, rng, 0.3)
    body[:, 3:6] = smooth_noise(T, 3, rng, 0.2)
    body[:, 6:16] = rng.randn(10).astype(np.float32) * 0.3
    body[:, 16:48] = smooth_noise(T, 32, rng, 0.5)
    body[:, 48:75] = smooth_noise(T, 27, rng, 0.2)
    return body + rng.randn(T, 75).astype(np.float32) * 0.1


# -- the GRU ----------------------------------------------------------------------

def test_random_params_bit_identical_to_reference():
    for seed in (0, 2):
        ref = JGRU.random_params(seed)
        got = TGRU.random_params(seed)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                          err_msg=k)


def test_forward_seq_matches_reference():
    rng = np.random.RandomState(3)
    ref_p = JGRU.random_params(1)
    # non-zero biases, so b_hn's placement matters
    ref_p = {k: (v + jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                 * 0.1) if "_b_" in k else v)
             for k, v in ref_p.items()}
    p = convert.gru_from_numpy({k: np.asarray(v) for k, v in ref_p.items()})
    B = 3
    pose = rng.randn(B, 32).astype(np.float32)
    h_e = rng.randn(B, TGRU.H_ENC).astype(np.float32) * 0.3
    h_d = rng.randn(B, TGRU.H_DEC).astype(np.float32) * 0.3
    noise = rng.randn(B, 4, TGRU.EPS_DIM).astype(np.float32)
    for kw_t, kw_j in (
            (dict(seq_length=1), dict(seq_length=1)),
            (dict(seq_length=4, h_enc=torch.tensor(h_e),
                  h_dec=torch.tensor(h_d), noise=torch.tensor(noise)),
             dict(seq_length=4, h_enc=jnp.asarray(h_e),
                  h_dec=jnp.asarray(h_d), noise=jnp.asarray(noise)))):
        got = TGRU.forward_seq(p, torch.tensor(pose), **kw_t)
        ref = JGRU.forward_seq(ref_p, jnp.asarray(pose), **kw_j)
        for a, b in zip(got, ref):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    # the reference call site's [B, 32, 1] pose and [B, 1, H] states
    got = TGRU.forward_seq(p, torch.tensor(pose[..., None]),
                           h_enc=torch.tensor(h_e[:, None]),
                           h_dec=torch.tensor(h_d[:, None]))
    ref = JGRU.forward_seq(ref_p, jnp.asarray(pose[..., None]),
                           h_enc=jnp.asarray(h_e[:, None]),
                           h_dec=jnp.asarray(h_d[:, None]))
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


class _MotionNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.gru_enc = torch.nn.GRU(TGRU.IN_DIM, TGRU.H_ENC)
        self.gru_dec = torch.nn.GRU(TGRU.H_ENC + TGRU.EPS_DIM, TGRU.H_DEC)
        self.out = torch.nn.Linear(TGRU.H_DEC, TGRU.IN_DIM)


def test_params_from_torch_state_dict_against_nn_gru():
    """A real torch.nn.GRU state dict: the port's cells reproduce
    nn.GRU's steps (b_hn unfolded), and the converted dict equals the
    reference converter's."""
    torch.manual_seed(0)
    net = _MotionNet()
    sd = net.state_dict()
    p = TGRU.params_from_torch_state_dict(sd)
    ref = JGRU.params_from_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    assert p.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, TGRU.IN_DIM, generator=g)
    h = torch.randn(2, TGRU.H_ENC, generator=g) * 0.5
    eps = torch.randn(2, TGRU.EPS_DIM, generator=g)
    with torch.no_grad():
        _, h_e = net.gru_enc(x[None], h[None])
        _, h_d = net.gru_dec(torch.cat([h_e[0], eps], -1)[None], h[None])
        pred = net.out(h_d[0])
        got = TGRU.forward_seq(p, x, 1, h_enc=h, h_dec=h,
                               noise=eps[:, None])
    torch.testing.assert_close(got[1], h_e[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2], h_d[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[0][..., 0], pred, rtol=1e-5, atol=1e-6)


# -- the smoothers ----------------------------------------------------------------

CFG = dict(num_iter=ITERS)


def test_fit_independent_matches_reference(clip):
    ref = np.asarray(JFF.fit_independent(jnp.asarray(clip),
                                         JConfig(**CFG)))
    got = TFF.fit_independent(clip, TConfig(**CFG), device="cpu")
    assert got.shape == (T, 75) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_fit_sequential_matches_reference(clip):
    ref = np.asarray(JFF.fit_sequential(jnp.asarray(clip), JConfig(**CFG)))
    got = TFF.fit_sequential(clip, TConfig(**CFG), device="cpu")
    assert got.shape == (T, 75)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_fit_sequential_motion_matches_reference(clip):
    gru = JGRU.random_params(seed=2)
    ref = np.asarray(JFF.fit_sequential_motion(jnp.asarray(clip), gru,
                                               JConfig(**CFG)))
    got = TFF.fit_sequential_motion(
        clip, convert.gru_from_numpy({k: np.asarray(v)
                                      for k, v in gru.items()}),
        TConfig(**CFG), device="cpu")
    assert got.shape == (T, 75)
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("fn", ["independent", "sequential", "motion"])
def test_first_step_meets_abs_at_zero(clip, fn):
    """One Adam step per frame: x starts exactly at its target, so every
    entry of the L1 reconstruction residual is 0; JAX's rule (d|x|/dx =
    +1 at 0) moves every entry by lr. torch.abs's 0 would leave most
    entries in place."""
    cfg = dict(num_iter=1)
    gru = JGRU.random_params(seed=2)
    if fn == "independent":
        ref = JFF.fit_independent(jnp.asarray(clip), JConfig(**cfg))
        got = TFF.fit_independent(clip, TConfig(**cfg), device="cpu")
    elif fn == "sequential":
        ref = JFF.fit_sequential(jnp.asarray(clip), JConfig(**cfg))
        got = TFF.fit_sequential(clip, TConfig(**cfg), device="cpu")
    else:
        ref = JFF.fit_sequential_motion(jnp.asarray(clip), gru,
                                        JConfig(**cfg))
        got = TFF.fit_sequential_motion(
            clip, convert.gru_from_numpy({k: np.asarray(v)
                                          for k, v in gru.items()}),
            TConfig(**cfg), device="cpu")
    np.testing.assert_allclose(got, np.asarray(ref), atol=5e-6)
    # frame 0's first step (fresh moments): every non-rotation entry
    # moved by about lr = 0.1
    assert np.abs(got[0, 6:] - clip[0, 6:]).min() > 0.09
    x = torch.zeros(5, requires_grad=True)
    losses.l1(torch.zeros(5), x).backward()
    assert torch.equal(x.grad, torch.full((5,), -0.2))


def test_motion_prior_makes_no_gru_step_at_frame_0(clip, monkeypatch):
    """The frame body runs the GRU for every frame, as the reference's
    scan body does, and frame 0's hidden-state update is masked (w[0] =
    0): frame 1's step starts from zero hidden states as frame 0's does,
    frame 2's from the states frame 1 made; frame 0 is fitted as the
    independent fit fits it."""
    calls = []
    real = TGRU.forward_seq

    def spy(params, pose_prev, seq_length=1, h_enc=None, h_dec=None,
            noise=None):
        calls.append((h_enc.clone(), h_dec.clone()))
        return real(params, pose_prev, seq_length, h_enc, h_dec, noise)

    monkeypatch.setattr(TGRU, "forward_seq", spy)
    cfg = TConfig(num_iter=5)
    got = TFF.fit_sequential_motion(clip[:4], TGRU.random_params(2), cfg,
                                    device="cpu")
    assert len(calls) == 4
    assert all(torch.count_nonzero(h) == 0 for h in calls[0] + calls[1])
    assert all(torch.count_nonzero(h) > 0 for h in calls[2])
    ind = TFF.fit_independent(clip[:1], cfg, device="cpu")
    np.testing.assert_allclose(got[0], ind[0], atol=1e-6)
