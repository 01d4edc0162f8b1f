"""Port parity: fpv4d_torch.models (VPoser decoder, synthetic SMPL-X,
FK and the SMPL-X forward, full and pruned) against the JAX package on
the same numpy-seeded inputs and the same tables (carried across with
fpv4d_torch.convert).

Tolerances: the model is f32 matmuls and FK compositions whose
summation order differs between XLA and PyTorch on the CPU; vertices
and joints are O(1) m, so atol 1e-5 (the reference's own prune-vs-full
tolerance, tests/test_joint_prune.py); gradients 1e-4."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fpv4d.core import rotations as jrot
from fpv4d.models import smplx as jsmplx
from fpv4d.models import vposer as jvp
from fpv4d.ops import contact as jcontact
from fpv4d_torch import convert
from fpv4d_torch.models import smplx as tsmplx
from fpv4d_torch.models import vposer as tvp
from fpv4d_torch.ops import contact as tcontact

V = 256


@pytest.fixture(scope="module")
def models():
    jm = jsmplx.synthetic_model(num_verts=V, seed=0, sparse_weights=True)
    tm = tsmplx.synthetic_model(num_verts=V, seed=0, sparse_weights=True)
    return jm, tm


@pytest.mark.parametrize("sparse", [False, True])
def test_synthetic_model_bit_identical(sparse):
    jm = jsmplx.synthetic_model(num_verts=V, seed=1, sparse_weights=sparse,
                                sparse_posedirs=sparse)
    arr = tsmplx.synthetic_arrays(num_verts=V, seed=1,
                                  sparse_weights=sparse,
                                  sparse_posedirs=sparse)
    for k in jsmplx.SmplxModel._LEAVES:
        np.testing.assert_array_equal(arr[k], np.asarray(getattr(jm, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(arr["faces"], jm.faces)
    np.testing.assert_array_equal(arr["lmk_faces_idx"], jm.lmk_faces_idx)
    np.testing.assert_array_equal(
        tsmplx.synthetic_vertex_bones(V, 1),
        jsmplx.synthetic_vertex_bones(V, 1))


@pytest.mark.parametrize("coherent", [False, True])
def test_synthetic_segments_identical(coherent):
    assert (tcontact.synthetic_segments(512, seed=0, coherent=coherent)
            == jcontact.synthetic_segments(512, seed=0, coherent=coherent))


def test_vposer_params_and_decode():
    jp = jvp.random_params(seed=3)
    tp = tvp.random_params(seed=3)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    # a checkpoint in the human_body_prior layout converts alike
    sd = {"bodyprior_dec_fc1.weight": np.asarray(jp["w1"]).T,
          "bodyprior_dec_fc1.bias": np.asarray(jp["b1"]),
          "bodyprior_dec_fc2.weight": np.asarray(jp["w2"]).T,
          "bodyprior_dec_fc2.bias": np.asarray(jp["b2"]),
          "bodyprior_dec_out.weight": np.asarray(jp["w3"]).T,
          "bodyprior_dec_out.bias": np.asarray(jp["b3"])}
    tp2 = tvp.params_from_torch_state_dict(sd)
    for k in jp:
        np.testing.assert_array_equal(tp2[k].numpy(), np.asarray(jp[k]))
    lat = np.random.RandomState(4).randn(9, 32).astype(np.float32)
    for out in ("aa", "matrot"):
        want = np.asarray(jvp.decode(jp, jnp.asarray(lat), out))
        got = tvp.decode(tp, torch.as_tensor(lat), out).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=out)
    gj = jax.grad(lambda z: jnp.sum(jvp.decode(jp, z, "matrot") ** 3))(
        jnp.asarray(lat))
    zt = torch.tensor(lat, requires_grad=True)
    (tvp.decode(tp, zt, "matrot") ** 3).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gj), atol=1e-5)
    np.testing.assert_allclose(
        float(tvp.latent_prior_loss(torch.as_tensor(lat))),
        float(jvp.latent_prior_loss(jnp.asarray(lat))), rtol=1e-6)


def _inputs(model, B=3, seed=7, matrot=False):
    rng = np.random.RandomState(seed)
    d = dict(
        betas=rng.randn(B, model.num_betas) * 0.3,
        global_orient=rng.randn(B, 3) * 0.2,
        body_pose=rng.randn(B, 63) * 0.2,
        transl=rng.randn(B, 3) * 0.1,
        left_hand_pose=rng.randn(B, model.num_pca) * 0.3,
        right_hand_pose=rng.randn(B, model.num_pca) * 0.3)
    d = {k: np.asarray(v, np.float32) for k, v in d.items()}
    if matrot:
        d["body_pose_matrot"] = np.asarray(jrot.aa_to_matrot(
            jnp.asarray(d["body_pose"]).reshape(B, 21, 3)))
        d["global_orient_matrot"] = np.asarray(jrot.aa_to_matrot(
            jnp.asarray(d["global_orient"])))
    return d


def _vids(model):
    segs = jcontact.synthetic_segments(V, seed=0, coherent=True)
    return np.concatenate([np.asarray(segs["L_Leg"], np.int32),
                           np.asarray(segs["R_Leg"], np.int32)])


@pytest.mark.parametrize("mode", ["full", "subset", "pruned", "matrot"])
def test_smplx_forward_matches(models, mode):
    jm, tm = models
    vids = _vids(jm)
    inp = _inputs(jm, matrot=mode == "matrot")
    kw = {}
    if mode in ("subset", "pruned", "matrot"):
        kw["vertex_subset"] = vids
    if mode in ("pruned", "matrot"):
        sup_j = jm.joint_support(vids)
        sup_t = tm.joint_support(vids)
        np.testing.assert_array_equal(sup_t[0], sup_j[0])
        assert (sup_t[1] is None) == (sup_j[1] is None)
        kw.update(joint_subset=sup_j[0], pose_joint_subset=sup_j[1])
    out_j = jm(**{k: jnp.asarray(v) for k, v in inp.items()}, **kw)
    out_t = tm(**{k: torch.as_tensor(v) for k, v in inp.items()}, **kw)
    for key in ("vertices", "joints", "full_pose", "v_shaped"):
        a, b = np.asarray(out_j[key]), out_t[key].numpy()
        np.testing.assert_array_equal(np.isnan(b), np.isnan(a),
                                      err_msg=key)
        np.testing.assert_allclose(np.nan_to_num(b), np.nan_to_num(a),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    if mode == "pruned":
        assert np.isnan(out_t["joints"].numpy()).any()  # pruned -> NaN


def test_smplx_gradients_match(models):
    jm, tm = models
    vids = _vids(jm)
    sup = jm.joint_support(vids)
    inp = _inputs(jm, B=2)

    def jloss(bp):
        kw = {k: jnp.asarray(v) for k, v in inp.items()}
        kw["body_pose"] = bp
        out = jm(**kw, vertex_subset=vids, joint_subset=sup[0],
                 pose_joint_subset=sup[1])
        return jnp.sum(out["vertices"] ** 2)

    gj = jax.grad(jloss)(jnp.asarray(inp["body_pose"]))
    kw = {k: torch.as_tensor(v) for k, v in inp.items()}
    bp = torch.tensor(inp["body_pose"], requires_grad=True)
    kw["body_pose"] = bp
    out = tm(**kw, vertex_subset=vids, joint_subset=sup[0],
             pose_joint_subset=sup[1])
    (out["vertices"] ** 2).sum().backward()
    np.testing.assert_allclose(bp.grad.numpy(), np.asarray(gj), atol=1e-4,
                               rtol=1e-4)


def test_fk_matches_reference():
    from fpv4d.models import fk as jfk
    from fpv4d_torch.models import fk as tfk
    rng = np.random.RandomState(5)
    rot = np.asarray(jrot.aa_to_matrot(jnp.asarray(
        rng.randn(2, 55, 3).astype(np.float32) * 0.3)))
    joints = rng.randn(2, 55, 3).astype(np.float32) * 0.3
    pj, rj = jfk.rigid_transform_ref(jnp.asarray(rot), jnp.asarray(joints),
                                     jsmplx.PARENTS)
    pt, rt = tfk._fwd_impl(torch.as_tensor(rot), torch.as_tensor(joints),
                            tsmplx.PARENTS)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)


def test_convert_carries_model(models, tmp_path):
    jm, tm = models
    arrays = {k: np.asarray(getattr(jm, k)) for k in jsmplx.SmplxModel._LEAVES}
    arrays["faces"] = jm.faces
    cm = convert.smplx_from_numpy(arrays)
    for k in tsmplx.SmplxModel.LEAVES:
        assert torch.equal(getattr(cm, k), getattr(tm, k)), k
    # the official .npz layout loads to the same tables
    path = tmp_path / "m.npz"
    np.savez(path, v_template=arrays["v_template"],
             shapedirs=np.concatenate([arrays["shapedirs"],
                                       np.zeros((V, 3, 290), np.float32),
                                       arrays["exprdirs"]], -1),
             posedirs=arrays["posedirs"].T.reshape(V, 3, -1),
             J_regressor=arrays["j_regressor"],
             weights=arrays["lbs_weights"],
             hands_componentsl=arrays["hands_components_l"],
             hands_componentsr=arrays["hands_components_r"],
             hands_meanl=arrays["hands_mean_l"],
             hands_meanr=arrays["hands_mean_r"], f=jm.faces)
    lm = tsmplx.load_npz(str(path))
    jl = jsmplx.load_npz(str(path))
    for k in tsmplx.SmplxModel.LEAVES:
        np.testing.assert_array_equal(getattr(lm, k).numpy(),
                                      np.asarray(getattr(jl, k)), err_msg=k)
