"""The port's vis package against the JAX package's fpv4d.vis (NumPy +
OpenCV) on the CPU, at small sizes with seeded numpy inputs.

Tolerances, each tightened to what the port reaches here:
  * Camera.project: rtol 1e-6 (the same f32 arithmetic; measured equal).
  * render_points (radius 1 and 3), draw_circles, the disc stencil,
    composite, rotation_x_180: exact.
  * render_mesh: the coverage rule is cv2.fillConvexPoly's, reproduced
    exactly (spans, outline lines, clipping): mask XOR 0 on the
    tessellated sphere at 1280x720 and on random meshes. Colours: on
    the sphere within 1 uint8 level everywhere both cover (the
    Lambertian dot products round differently in BLAS and torch), at
    least 99.9% exact; on random meshes at least 99% within 1 level,
    because faces tied in mean depth keep their index order here (a
    stable sort) and not always in NumPy's quicksort.
  * render_dir (ego: all three sources; world: fixed, follow, orbit) on
    small models with ConvexHull faces: the same file lists, vertices
    of the chunked forward within atol 1e-5 of the reference's
    per-frame forward, PNGs within 1 level with mask XOR 0 and at least
    99.9% of pixels exact.
  * body_to_world, camera_center, orbit_view: atol 1e-6.
"""
import dataclasses
import io
import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial import ConvexHull

from fpv4d.io import body_pkl as JBP
from fpv4d.models import smplx as JS
from fpv4d.models import vposer as JV
from fpv4d.vis import ego_overlay as JE
from fpv4d.vis import raster as JR
from fpv4d.vis import world_view as JW
from fpv4d_torch.models import smplx as TS
from fpv4d_torch.models import vposer as TV
from fpv4d_torch.vis import ego_overlay as TE
from fpv4d_torch.vis import frames as TF
from fpv4d_torch.vis import interactive as TI
from fpv4d_torch.vis import png as TPNG
from fpv4d_torch.vis import raster as TR
from fpv4d_torch.vis import world_view as TW

SMALL = dict(width=160, height=120, fx=100.0, fy=100.0, cx=80.0, cy=60.0)


def _cams(**kw):
    return JR.Camera(**kw), TR.Camera(**kw)


def _sphere(nu=64, nv=32, r=0.8, c=(0.0, 0.0, -3.0)):
    """A UV sphere: nu x nv quads split into triangles, poles fanned."""
    th = np.linspace(0, np.pi, nv + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)),
                     np.outer(np.sin(th), np.sin(ph)),
                     np.outer(np.cos(th), np.ones(nu))], -1).reshape(-1, 3)
    v = np.concatenate([[[0, 0, 1]], ring, [[0, 0, -1]]]) * r + c
    j = np.arange(nu)
    f = [np.stack([np.zeros(nu, int), 1 + j, 1 + (j + 1) % nu], 1)]
    for i in range(nv - 2):
        a, b = 1 + i * nu + j, 1 + i * nu + (j + 1) % nu
        f += [np.stack([a, a + nu, b], 1), np.stack([b, a + nu, b + nu], 1)]
    last = len(v) - 1
    base = 1 + (nv - 2) * nu
    f.append(np.stack([np.full(nu, last), base + (j + 1) % nu, base + j], 1))
    return v.astype(np.float32), np.concatenate(f).astype(np.int32)


def _mesh_diff(ref, port):
    """(mask XOR share of the reference's mask, share of pixels both
    cover that are exact, share within 1 uint8 level)."""
    (rj, mj), (rt, mt) = ref, port
    rt, mt = rt.numpy(), mt.numpy()
    xor = float((mj != mt).sum() / max(mj.sum(), 1))
    both = (mj[..., 0] > 0) & (mt[..., 0] > 0)
    d = np.abs(np.round(rj * 255).astype(int)
               - np.round(rt * 255).astype(int)).max(-1)[both]
    return xor, float(np.mean(d == 0)), float(np.mean(d <= 1))


def test_camera_project():
    rng = np.random.RandomState(0)
    pts = (rng.randn(500, 3) * [1.0, 1.0, 2.0] - [0, 0, 3]).astype(np.float32)
    for kw in ({}, SMALL):
        jc, tc = _cams(**kw)
        uv_j, z_j = jc.project(pts)
        uv_t, z_t = tc.project(torch.from_numpy(pts))
        np.testing.assert_allclose(uv_t.numpy(), uv_j, rtol=1e-6)
        np.testing.assert_allclose(z_t.numpy(), z_j, rtol=1e-6)


@pytest.mark.parametrize("radius", [1, 3])
@pytest.mark.parametrize("with_image", [False, True])
def test_render_points_exact(radius, with_image):
    rng = np.random.RandomState(radius)
    n = 400
    pts = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1, 1, n),
                    -np.linspace(1.5, 6.0, n)[rng.permutation(n)]],
                   1).astype(np.float32)                # distinct depths
    cols = rng.rand(n, 3).astype(np.float32)
    image = rng.rand(120, 160, 3).astype(np.float32) if with_image else None
    jc, tc = _cams(**SMALL)
    for c in (None, cols, np.array([1.0, 0.0, 0.0])):
        ref = JR.render_points(pts, jc, colors=c, radius=radius, image=image)
        got = TR.render_points(
            torch.from_numpy(pts), tc, colors=c, radius=radius,
            image=None if image is None else torch.from_numpy(image))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_draw_circles_exact():
    rng = np.random.RandomState(2)
    img = rng.rand(120, 160, 3).astype(np.float32)
    uv = np.concatenate([rng.uniform(-10, 170, (30, 2)),
                         [[80.5, 60.5], [1.5, 118.5]]]).astype(np.float32)
    for r in (1, 4, 7):
        ref = JR.draw_circles(img, uv, radius=r)
        got = TR.draw_circles(torch.from_numpy(img), torch.from_numpy(uv),
                              radius=r)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("r", range(1, 9))
def test_disc_stencil_matches_cv2(r):
    for cx, cy in ((20, 20), (1, 38), (-3, 5)):
        ref = np.zeros((40, 40), np.uint8)
        cv2.circle(ref, (cx, cy), r, 255, -1)
        _, pix = TR._disc_pixels(torch.tensor([[cx, cy]]), r, 40, 40)
        got = np.zeros(1600, np.uint8)
        got[pix.numpy()] = 255
        np.testing.assert_array_equal(got.reshape(40, 40), ref)


def test_lines_and_triangles_match_cv2():
    """The outline lines (clipped as cv2.clipLine clips) and the whole
    fillConvexPoly coverage of random triangles, in and across the
    image border, pixel for pixel."""
    rng = np.random.RandomState(0)
    H, W = 60, 80
    a = rng.randint(-40, 120, (400, 2))
    b = rng.randint(-40, 120, (400, 2))
    line, pix = TR._line_pixels(torch.from_numpy(a), torch.from_numpy(b),
                                H, W)
    for i in range(len(a)):
        ref = np.zeros((H, W), np.uint8)
        cv2.line(ref, tuple(map(int, a[i])), tuple(map(int, b[i])), 255, 1,
                 cv2.LINE_8)
        got = np.zeros(H * W, np.uint8)
        got[pix[line == i].numpy()] = 255
        np.testing.assert_array_equal(got.reshape(H, W), ref, err_msg=str(i))
    for t in range(400):
        s = (15, 30, 200)[t % 3]
        p = rng.randint(-s // 3, s, (3, 2))
        ref = np.zeros((H, W), np.uint8)
        cv2.fillConvexPoly(ref, p.astype(np.int32), 255,
                           lineType=cv2.LINE_8)
        pt = torch.from_numpy(p)[None]
        tab = TR._span_tables(H, W, "cpu")
        ends = torch.stack([pt.roll(1, dims=1), pt], 2).reshape(-1, 2, 2)
        _, lp = TR._line_pixels(ends[:, 0], ends[:, 1], H, W)
        TR._draw(tab[0], lp, torch.zeros(len(lp), dtype=torch.int32))
        face, y, x0, x1 = TR._fill_spans(pt, H, W)
        TR._draw_spans(tab, y * W, x0, x1,
                       torch.zeros(len(face), dtype=torch.int32))
        got = (TR._push_down(tab, H, W) >= 0).numpy().reshape(H, W)
        np.testing.assert_array_equal(got, ref > 0, err_msg=str(p))


def test_composite_and_rotation_exact():
    rng = np.random.RandomState(3)
    rgb, bg = rng.rand(2, 6, 7, 3).astype(np.float32)
    mask = (rng.rand(6, 7, 1) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        TR.composite(*map(torch.from_numpy, (rgb, mask, bg))).numpy(),
        JR.composite(rgb, mask, bg))
    np.testing.assert_array_equal(TR.rotation_x_180().numpy(),
                                  JR.rotation_x_180())


def test_painter_occlusion_winner():
    """The reference's occlusion case (two triangles, the near one half
    size): the near face wins inside the overlap. With the near one
    tilted its colour differs, and the images are equal."""
    jc, tc = _cams(width=100, height=100, fx=100.0, fy=100.0, cx=50.0,
                   cy=50.0)
    tri = np.array([[-1, -1], [1, -1], [0, 1]], dtype=np.float32)
    far = np.concatenate([tri, np.full((3, 1), -5.0)], 1)
    for tilt in (0.0, 0.4):
        near = np.concatenate([tri * 0.5, np.full((3, 1), -2.0)
                               + tilt * tri[:, :1]], 1)
        verts = np.concatenate([far, near]).astype(np.float32)
        faces = np.array([[0, 1, 2], [3, 4, 5]], dtype=np.int32)
        rj, mj = JR.render_mesh(verts, faces, jc)
        rt, mt = TR.render_mesh(torch.from_numpy(verts), faces, tc)
        np.testing.assert_array_equal(mt.numpy(), mj)
        np.testing.assert_array_equal(rt.numpy(), rj)
        if tilt:
            only_near, _ = TR.render_mesh(torch.from_numpy(verts),
                                          faces[1:], tc)
            np.testing.assert_array_equal(rt[50, 50], only_near[50, 50])
            assert not torch.equal(rt[50, 50], TR.render_mesh(
                torch.from_numpy(verts), faces[:1], tc)[0][50, 50])


def test_render_mesh_sphere_full_frame():
    v, f = _sphere()
    jc, tc = _cams()
    xor, exact, within1 = _mesh_diff(JR.render_mesh(v, f, jc),
                                     TR.render_mesh(torch.from_numpy(v), f,
                                                    tc))
    assert xor == 0.0
    assert exact >= 0.999 and within1 == 1.0, (exact, within1)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_render_mesh_random_mesh(seed):
    """The synthetic model's random-triangle faces (large, overlapping,
    crossing the border) at 320x240, with a background image."""
    jm = JS.synthetic_model(num_verts=512, seed=seed)
    v = (np.asarray(jm.v_template) * [1, -1, -1] - [0, 0, 2.5]).astype(
        np.float32)
    kw = dict(width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0)
    jc, tc = _cams(**kw)
    bg = np.random.RandomState(seed).rand(240, 320, 3).astype(np.float32)
    ref = JR.render_mesh(v, jm.faces, jc, image=bg)
    got = TR.render_mesh(torch.from_numpy(v), jm.faces, tc,
                         image=torch.from_numpy(bg))
    xor, exact, within1 = _mesh_diff(ref, got)
    assert xor == 0.0
    # seed 2 has two pairs of faces at exactly equal mean depth: the port
    # orders ties by a stable sort, NumPy's quicksort may swap them, and
    # where such a pair overlaps the other face wins (0.9932 there)
    assert exact >= 0.99 and within1 >= 0.99, (exact, within1)
    # outside the mask both keep the quantised background
    out = ref[1][..., 0] == 0
    np.testing.assert_array_equal(got[0].numpy()[out], ref[0][out])


def test_render_mesh_chunks_and_culling(monkeypatch):
    """A chunk far smaller than the mesh's face-rows and outline pixels,
    faces behind the camera and faces off the image give the same
    image."""
    jm = JS.synthetic_model(num_verts=256, seed=4)
    v = (np.asarray(jm.v_template) * [1, -1, -1] - [0.6, 0, 1.2]).astype(
        np.float32)
    jc, tc = _cams(**SMALL)
    want = TR.render_mesh(torch.from_numpy(v), jm.faces, tc)
    monkeypatch.setattr(TR, "CHUNK", 37)
    got = TR.render_mesh(torch.from_numpy(v), jm.faces, tc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    xor, _, within1 = _mesh_diff(JR.render_mesh(v, jm.faces, jc), got)
    assert xor == 0.0 and within1 == 1.0
    empty = TR.render_mesh(torch.from_numpy(v) + 50.0, jm.faces, tc)
    assert float(empty[1].sum()) == 0.0


# -- render_dir on small models --------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """The reference's and the port's synthetic model (bit-identical
    arrays) with the same ConvexHull faces, and both VPosers."""
    jm = JS.synthetic_model(num_verts=256, seed=3)
    faces = ConvexHull(np.asarray(jm.v_template)).simplices.astype(np.int32)
    tm = TS.synthetic_model(num_verts=256, seed=3)
    tm.faces = faces
    return (dataclasses.replace(jm, faces=faces), JV.random_params(seed=3),
            tm, TV.random_params(seed=3))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 5-frame clip with scale and camera_ext, as smoothed_body/ and
    as body_gen/ results."""
    rng = np.random.RandomState(4)
    T = 5
    body = (rng.randn(T, 75) * 0.1).astype(np.float32)
    body[:, 74] = 2.5
    cam_ext = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    cam_ext[:, 2, 3] = -3.0 + 0.1 * np.arange(T)
    cam_ext[:, 0, 3] = 0.05 * np.arange(T)
    root = tmp_path_factory.mktemp("clip")
    JBP.save_clip(str(root / "smoothed_body"), body, scale=1.2,
                  camera_ext=cam_ext, prefix="")
    JBP.save_clip(str(root / "body_gen"), body, scale=1.2,
                  camera_ext=cam_ext)
    return root, body, rng.randn(300, 3).astype(np.float32)


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        ia = np.asarray(Image.open(os.path.join(a, n))).astype(int)
        ib = np.asarray(Image.open(os.path.join(b, n))).astype(int)
        d = np.abs(ia - ib).max(-1)
        assert d.max() <= 1 and np.mean(d == 0) >= 0.999, n
        np.testing.assert_array_equal(ia.sum(-1) > 0, ib.sum(-1) > 0)
        assert (ia.sum(-1) > 0).mean() > 0.005, n
    return names


def test_chunked_forward_matches_reference(models, clip):
    jm, jvp, tm, tvp = models
    root, body, _ = clip
    params = [JBP.load_frame(str(p))
              for p in sorted((root / "smoothed_body").glob("*.pkl"))]
    verts, joints = TF.body_forward(tm, tvp, params)
    for i, p in enumerate(params):
        out = jm(betas=jnp.asarray(p["betas"]),
                 global_orient=jnp.asarray(p["global_orient"]),
                 body_pose=JV.decode(jvp, jnp.asarray(p["body_pose"])),
                 transl=jnp.asarray(p["transl"]),
                 left_hand_pose=jnp.asarray(p["left_hand_pose"]),
                 right_hand_pose=jnp.asarray(p["right_hand_pose"]))
        np.testing.assert_allclose(verts[i].numpy(),
                                   np.asarray(out["vertices"][0]), atol=1e-5)
        np.testing.assert_allclose(joints[i].numpy(),
                                   np.asarray(out["joints"][0, :23]),
                                   atol=1e-5)


@pytest.mark.parametrize("source", ["smoothed", "local", "baseline"])
def test_ego_render_dir_matches_reference(models, clip, source, tmp_path):
    jm, jvp, tm, tvp = models
    root, _, _ = clip
    work = tmp_path / "clip"
    shutil.copytree(root, work)
    d = str(work / ("body_gen/x" if source == "baseline"
                    else "smoothed_body"))
    out = os.path.join(os.path.dirname(d),
                       {"smoothed": "smoothed_vis", "local": "local_vis",
                        "baseline": "baseline_vis"}[source])
    jc, tc = _cams(**SMALL)
    assert JE.render_dir(d, jm, jvp, source=source, camera=jc) == 5
    shutil.move(out, tmp_path / "ref")
    stats = {}
    assert TE.render_dir(d, tm, tvp, source=source, camera=tc,
                         stats=stats) == 5
    names = _same_dirs(tmp_path / "ref", out)
    assert names == [f"{i:04d}.png" for i in range(5)]
    assert len(stats["mask_pixels"]) == 5 and min(stats["mask_pixels"]) > 0
    assert {"forward", "mesh", "encode"} <= set(stats)
    assert ("points" in stats) == (source == "local")


@pytest.mark.parametrize("mode", ["fixed", "follow", "orbit"])
def test_world_render_dir_matches_reference(models, clip, mode, tmp_path):
    jm, jvp, tm, tvp = models
    root, _, scene = clip
    kw = {"fixed": {}, "follow": {"follow": True},
          "orbit": {"orbit": True, "orbit_turns": 0.5}}[mode]
    d = str(root / "smoothed_body")
    assert JW.render_dir(d, jm, jvp, scene, str(tmp_path / "ref"),
                         **kw) == 5
    stats = {}
    assert TW.render_dir(d, tm, tvp, scene, str(tmp_path / "port"),
                         stats=stats, **kw) == 5
    names = _same_dirs(tmp_path / "ref", tmp_path / "port")
    assert names == [f"img_{i:03d}.png" for i in range(5)]
    assert {"forward", "points", "mesh", "encode"} <= set(stats)
    assert TW.render_dir(d, tm, tvp, scene, str(tmp_path / "lim"),
                         limit=2, **kw) == 2


def test_world_geometry_matches_reference():
    rng = np.random.RandomState(5)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    ext[:3, 3] = rng.randn(3)
    param = {"camera_translation": rng.randn(1, 3).astype(np.float32),
             "scale": np.float32(1.3), "camera_ext": ext}
    np.testing.assert_allclose(TW.body_to_world(param).numpy(),
                               JW.body_to_world(param), atol=1e-6)
    np.testing.assert_allclose(
        TW.body_to_world({"camera_translation": param["camera_translation"]}
                         ).numpy(),
        JW.body_to_world({"camera_translation": param["camera_translation"]}),
        atol=1e-6)
    np.testing.assert_allclose(TW.camera_center(torch.from_numpy(ext)).numpy(),
                               JW.camera_center(ext), atol=1e-6)
    c = rng.randn(3).astype(np.float32)
    for az, el in ((0.0, 0.35), (2.1, -0.4), (5.0, 1.2)):
        np.testing.assert_allclose(
            TW.orbit_view(torch.from_numpy(c), 3.5, az, el).numpy(),
            JW.orbit_view(c, 3.5, az, el), atol=1e-6)


def test_render_frames_match_reference(models, clip):
    """The one-frame entry points, with a background and the joints."""
    jm, jvp, tm, tvp = models
    root, _, scene = clip
    p = JBP.load_frame(str(sorted((root / "smoothed_body").glob("*"))[2]))
    jc, tc = _cams(**SMALL)
    bg = np.random.RandomState(6).rand(120, 160, 3).astype(np.float32)
    ref = JE.render_frame(jm, jvp, p, jc, apply_scale=True, background=bg,
                          draw_joints=True)
    got = TE.render_frame(tm, tvp, p, tc, apply_scale=True, background=bg,
                          draw_joints=True)
    assert np.abs(got.numpy() - ref).max() <= 1.0 / 255 + 1e-6
    view = np.asarray(p["camera_ext"])
    traj = np.asarray([[0.0, 0.0, -3.0], [0.05, 0.0, -2.9]], np.float32)
    ref = JW.render_frame(jm, jvp, p, scene, view, traj)
    got = TW.render_frame(tm, tvp, p, scene, view, traj)
    d = np.abs(got.numpy() - ref)
    assert d.max() <= 1.0 / 255 + 1e-6 and np.mean(d == 0) >= 0.999


def test_background_needs_cv2(tmp_path, monkeypatch):
    """An existing frame is read with cv2; without cv2 the read raises
    and names it (the frame is never skipped); no frame -> None."""
    img = (np.random.RandomState(7).rand(30, 40, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "0003.png"), img)
    cam = TR.Camera(**SMALL)
    got = TE._load_background(str(tmp_path), 3, cam)
    ref = JE._load_background(str(tmp_path), 3, JR.Camera(**SMALL))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert TE._load_background(str(tmp_path), 4, cam) is None
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        TE._load_background(str(tmp_path), 3, cam)


# -- the interactive viewer ------------------------------------------------------

def test_interactive_server(models, clip):
    _, _, tm, tvp = models
    root, _, scene = clip
    viewer = TI.InteractiveViewer(str(root / "smoothed_body"), tm, tvp,
                                  scene)
    srv = TI.make_server(viewer, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read()

    try:
        code, ctype, body = get("/meta")
        assert code == 200 and json.loads(body) == {"num_frames": 5}
        assert b"<html>" in get("/")[2]
        for mode, i in (("fixed", 1), ("follow", 3), ("orbit", 2)):
            q = f"/frame?i={i}&mode={mode}&azim=0.7&elev=0.3&zoom=1.2"
            code, ctype, png = get(q)
            assert code == 200 and ctype == "image/png"
            img = np.asarray(Image.open(io.BytesIO(png)))
            assert img.shape == (720, 1280, 3)
            assert np.array_equal(img, TPNG.decode_png(png))
            cams = viewer.cams
            view = {"fixed": cams[0], "follow": cams[i],
                    "orbit": TW.orbit_view(viewer.center,
                                           viewer.radius * 1.2, 0.7, 0.3)
                    }[mode]
            own = TW.render_frame(tm, tvp, viewer.params[i], scene, view,
                                  viewer.trajectory[:i + 1])
            np.testing.assert_array_equal(
                img, (torch.clamp(own, 0, 1) * 255).to(torch.uint8).numpy())
            n = len(viewer._cache)
            assert get(q)[2] == png and len(viewer._cache) == n   # memo hit
        with pytest.raises(urllib.error.HTTPError) as e:
            get("/nope")
        assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    assert not th.is_alive()


# -- PNG -------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 5, 3), (33, 17), (1, 1, 3),
                                   (9, 4, 1)])
def test_png_round_trip(shape, tmp_path):
    img = (np.random.RandomState(8).rand(*shape) * 256).astype(np.uint8)
    data = TPNG.encode_png(torch.from_numpy(img))
    want = img[..., 0] if img.ndim == 3 and img.shape[2] == 1 else img
    np.testing.assert_array_equal(TPNG.decode_png(data), want)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  want)
    (tmp_path / "x.png").write_bytes(data)
    flag = cv2.IMREAD_UNCHANGED
    back = cv2.imread(str(tmp_path / "x.png"), flag)
    np.testing.assert_array_equal(
        back[..., ::-1] if back.ndim == 3 else back, want)


def test_png_rejects_what_it_cannot_write():
    with pytest.raises(ValueError):
        TPNG.encode_png(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        TPNG.encode_png(np.zeros((4, 4, 4), np.uint8))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 4), np.uint8)).save(buf, format="PNG")
    with pytest.raises(ValueError):
        TPNG.decode_png(buf.getvalue())
    good = TPNG.encode_png(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="CRC"):
        TPNG.decode_png(good[:-5] + bytes([good[-5] ^ 1]) + good[-4:])
    with pytest.raises(ValueError):
        TPNG.decode_png(b"GIF89a")
