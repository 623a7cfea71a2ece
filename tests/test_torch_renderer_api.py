"""The generic renderer path of hoig_torch against hoig_tpu on the CPU: the
resampling helpers, texture sampling and lighting, depth / silhouette / soft
coverage, look_at and proj_func, the mesh helpers, the off-path renderer
functions on the synthetic environment, cal_hand_bbox and the neural
renderer's Mesh / Renderer objects. 32 px, a 30-vertex blob or the synthetic
hand and objects, textures of size 2, inputs from numpy seeds. The JAX
references run under jax.jit, as the JAX package's rasterizer already does
(one compile instead of one per eager op), except grid_sample_packed: its
jitted form contracts the bilinear sums into FMAs, 7e-7 from the port's.

fim agrees exactly here; the JAX package's jitted planes contract products
into FMAs on XLA:CPU (ROADMAP section C) and the port rounds each product,
so barycentric weights and the maps built from them differ by up to 2e-5
(bound 1e-4, as tests/test_torch_conditioning.py) and depth by up to 3e-6
(bound 1e-5)."""

import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import ConvexHull

from hoig_tpu.geometry import conditioning as jcond
from hoig_tpu.geometry import mesh as jmesh
from hoig_tpu.geometry import neural_renderer_api as jnr
from hoig_tpu.geometry import projection as jproj
from hoig_tpu.geometry import renderer as jrend
from hoig_tpu.ops import rasterizer as jras
from hoig_tpu.ops import texture as jtex
from hoig_torch.data import synthetic as tsyn
from hoig_torch.geometry import conditioning as tcond
from hoig_torch.geometry import mesh as tmesh
from hoig_torch.geometry import neural_renderer_api as tnr
from hoig_torch.geometry import projection as tproj
from hoig_torch.geometry import renderer as trend
from hoig_torch.ops import grid_sample as tgs
from hoig_torch.ops import rasterizer as tras
from hoig_torch.ops import texture as ttex

# hoig_tpu.ops re-exports its function grid_sample over the module's name
jgs = importlib.import_module("hoig_tpu.ops.grid_sample")

torch.set_num_threads(1)

S, B = 32, 2
T = torch.as_tensor
EYE = (0.0, 0.0, -2.732)
_TABLE_KEYS = ("faces", "face_valid", "num_faces", "map_fn", "sem", "fim_uv", "wim_uv",
               "faces_uv_coord", "obj_tex")


def blob(n: int = 30, seed: int = 0):
    """A closed convex mesh around the origin, faces wound outwards: (V, 3)
    f32 vertices, (F, 3) int32 faces."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(n, 3)
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True) * (1 + 0.1 * rng.rand(n, 1))
    f = ConvexHull(pts).simplices.copy()
    nrm = np.cross(pts[f[:, 1]] - pts[f[:, 0]], pts[f[:, 2]] - pts[f[:, 0]])
    inward = (nrm * pts[f].mean(1)).sum(1) < 0
    f[inward] = f[inward][:, ::-1]
    return pts.astype(np.float32), f.astype(np.int32)


def blob_scene(seed: int = 1):
    """(B, V, 3) world vertices of two shifted blobs and their view-space
    face corners under look_at from EYE, in both packages."""
    v, f = blob()
    rng = np.random.RandomState(seed)
    verts = np.stack([v * 0.8 + rng.randn(3).astype(np.float32) * 0.1 for _ in range(B)])
    fv_j = jproj.vertices_to_faces(jproj.look_at(jnp.asarray(verts), EYE), jnp.asarray(f))
    fv_t = tproj.vertices_to_faces(tproj.look_at(T(verts), EYE), T(f))
    return verts, f, fv_j, fv_t


def _jit(fn, **static):
    """The JAX reference under one jax.jit, `static` bound: one compile on
    XLA:CPU instead of one per eager op (seconds for these graphs)."""
    return jax.jit(functools.partial(fn, **static))


def _close(a, b, atol, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=what)


# ------------------------------------------------------------ ops


@pytest.mark.parametrize("fn", ["grid_sample_packed", "resize_bilinear_align_corners",
                                "resize_nearest", "avg_pool"])
def test_resampling_matches_jax(fn):
    rng = np.random.RandomState(3)
    img = rng.randn(2, 3, 12, 10).astype(np.float32)
    if fn == "grid_sample_packed":
        grid = (rng.rand(2, 7, 9, 2) * 2.4 - 1.2).astype(np.float32)  # some corners outside
        for ac in (False, True):
            _close(tgs.grid_sample_packed(T(img), T(grid), ac),
                   jgs.grid_sample_packed(jnp.asarray(img), jnp.asarray(grid), ac), 1e-6, ac)
    elif fn == "avg_pool":
        for ks, stride in ((2, None), (3, 2)):
            _close(tgs.avg_pool(T(img), ks, stride),
                   _jit(jgs.avg_pool, ks=ks, stride=stride)(jnp.asarray(img)), 1e-6)
        _close(tgs.avg_pool(T(img[:, 0]), 2),
               _jit(jgs.avg_pool, ks=2)(jnp.asarray(img[:, 0])), 1e-6)
    else:
        for hw in ((20, 17), (5, 4)):
            # nearest picks exact values; the bilinear weights agree to f32 rounding
            _close(getattr(tgs, fn)(T(img), hw),
                   jax.jit(getattr(jgs, fn), static_argnums=1)(jnp.asarray(img), hw),
                   1e-6 if "bilinear" in fn else 0.0, hw)


def test_lighting_and_trilinear_sampling_match_jax():
    rng = np.random.RandomState(4)
    nf, t = 7, 3
    fv = rng.randn(B, nf, 3, 3).astype(np.float32)
    tex = rng.rand(B, nf, t, t, t, 3).astype(np.float32)
    kw = dict(intensity_ambient=0.3, intensity_directional=0.6, color_ambient=(1.0, 0.9, 0.8),
              color_directional=(0.7, 1.0, 1.0), direction=(0.2, 1.0, -0.5))
    _close(ttex.lighting(T(fv), T(tex), **kw),
           _jit(jtex.lighting, **kw)(jnp.asarray(fv), jnp.asarray(tex)), 1e-6)
    fim = rng.randint(-1, nf, (B, 5, 6)).astype(np.int32)
    wim = rng.rand(B, 5, 6, 3).astype(np.float32) * 1.2 - 0.1  # clamped to [0, 1] inside
    bg = (0.25, 0.5, 1.0)
    _close(ttex.sample_textures_trilinear(T(tex), T(fim), T(wim), bg),
           _jit(jtex.sample_textures_trilinear, background_color=bg)(
               jnp.asarray(tex), jnp.asarray(fim), jnp.asarray(wim)), 1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_depth_and_silhouette_match_jax(masked):
    """rasterize_depth and rasterize_silhouette (the B2 / B3 route, run plain
    on CPU tensors) against JAX's dense rasterizer, with and without a face
    mask; plus the fim / wim of the same finish."""
    _, f, fv_j, fv_t = blob_scene()
    valid = np.random.RandomState(5).rand(B, f.shape[0]) > 0.3 if masked else None
    vj = None if valid is None else jnp.asarray(valid)
    vt = None if valid is None else T(valid)
    near, far = 0.5, 20.0
    fim_t, wim_t, d_t = tras._hard_maps(fv_t, vt, S, near, far, 16, True)
    fim_j, wim_j = jras.rasterize_fim_wim(fv_j, vj, image_size=S, near=near, far=far, chunk=16)
    np.testing.assert_array_equal(fim_t.numpy(), np.asarray(fim_j))
    assert 100 < int((fim_t >= 0).sum()) < B * S * S  # object and background in view
    _close(wim_t, wim_j, 1e-4, "wim")
    d_ref = jras.rasterize_depth(fv_j, vj, image_size=S, near=near, far=far)
    _close(tras.rasterize_depth(fv_t, vt, S, near, far), d_ref, 1e-5, "depth")
    assert float(d_t.max()) == far and float(d_t.min()) < 3.0
    _close(tras.rasterize_silhouette(fv_t, vt, S, near, far),
           jras.rasterize_silhouette(fv_j, vj, image_size=S, near=near, far=far), 0.0, "sil")


def test_soft_silhouette_and_its_gradient_match_jax():
    """Values within 1e-6; the vertex gradient of a random weighting within
    1e-5 of its largest entry (measured 8e-7: sums in another order). The
    port walks the faces in chunks of 7 here, so the running maximum crosses
    chunk borders."""
    _, _, fv_j, fv_t = blob_scene()
    g = np.random.RandomState(6).randn(B, S, S).astype(np.float32)
    ref, pull = jax.vjp(lambda x: jras.soft_silhouette(x, image_size=S, sigma=0.7), fv_j)
    (g_ref,) = pull(jnp.asarray(g))
    x = fv_t.clone().requires_grad_()
    out = tras.soft_silhouette(x, image_size=S, sigma=0.7, chunk=7)
    (out * T(g)).sum().backward()
    _close(out, ref, 1e-6, "soft")
    top = float(np.abs(np.asarray(g_ref)).max())
    assert top > 1.0
    _close(x.grad, g_ref, 1e-5 * top, "soft grad")
    # a face that repeats a vertex: a finite gradient where the JAX
    # package's is NaN (sqrt's gradient at a zero-length edge). The values
    # are not compared there: XLA:CPU's FMA leaves that edge's constant
    # term a rounding residue instead of 0, which moves the coverage near
    # the degenerate face's line.
    fv_d = fv_t.clone()
    fv_d[:, 0, 1] = fv_d[:, 0, 0]
    _, pull_d = jax.vjp(lambda v: jras.soft_silhouette(v, image_size=S, sigma=0.7),
                        jnp.asarray(fv_d.numpy()))
    assert np.isnan(np.asarray(pull_d(jnp.asarray(g))[0])).any()
    x = fv_d.requires_grad_()
    (tras.soft_silhouette(x, image_size=S, sigma=0.7, chunk=7) * T(g)).sum().backward()
    assert bool(torch.isfinite(x.grad).all())


# ------------------------------------------------------------ geometry


def test_look_at_and_proj_func_match_jax():
    rng = np.random.RandomState(7)
    v = rng.randn(B, 9, 3).astype(np.float32)
    for eye, at, up in ((EYE, (0, 0, 0), (0, 1, 0)), ((1.0, 2.0, -3.0), (0.1, -0.2, 0.3),
                                                       (0.0, 0.0, 1.0))):
        _close(tproj.look_at(T(v), eye, at, up), jproj.look_at(jnp.asarray(v), eye, at, up), 1e-6)
    rot = np.linalg.qr(rng.randn(B, 3, 3))[0].astype(np.float32)
    transl = (rng.randn(B, 3) * 0.1 + [0, 0, 5]).astype(np.float32)
    center = (rng.rand(B, 2) * 100).astype(np.float32)
    args = (v, transl, rot, center)
    ref = jproj.proj_func(*map(jnp.asarray, args))
    _close(tproj.proj_func(*map(T, args)), ref, 1e-5 * float(np.abs(np.asarray(ref)).max()))


def test_save_obj_and_map_dims_match_jax(tmp_path):
    v, f = blob(12)
    tmesh.save_obj(v, f, str(tmp_path / "t.obj"))
    jmesh.save_obj(v, f, str(tmp_path / "j.obj"))
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    back = tmesh.load_obj(str(tmp_path / "t.obj"))
    np.testing.assert_array_equal(back["faces"], f)
    np.testing.assert_allclose(back["vertices"], v, rtol=1e-6)
    for name in ("seg", "uv", "uv_seg", "par", "ids", "binary"):
        assert tmesh.get_map_fn_dim(name) == jmesh.get_map_fn_dim(name)
    with pytest.raises(ValueError):
        tmesh.get_map_fn_dim("depth")


def test_cal_hand_bbox_matches_jax():
    kps = (np.random.RandomState(8).rand(3, 21, 2) * 2.2 - 1.1).astype(np.float32)
    for factor in (1.2, 2.0):
        out = tcond.cal_hand_bbox(T(kps), 64, factor)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), np.asarray(
            jcond.cal_hand_bbox(jnp.asarray(kps), 64, factor)))


def make_scene():
    """The synthetic hand + object tables at 32 px, a batch of two posed
    hands (cam, verts, obj_id) and random per-face textures of size 2. The
    port builds them (its tables and get_details are held against the JAX
    package's in tests/test_torch_conditioning.py) and both sides get the
    same arrays: the JAX package's would add seconds of compiles per
    worker and change no comparison here."""
    env = tsyn.synthetic_environment(2, S, device="cpu")
    theta = tsyn.synthetic_theta(B, env["obj_verts"], seed=3, image_size=S)
    det = tcond.get_details(env["mano_params"], {k: T(v) for k, v in theta.items()},
                            tcond.ConditioningConfig(image_size=S))
    det = {k: v.numpy() for k, v in det.items()}
    tables = env["tables_np"]
    tex = np.random.RandomState(9).rand(B, tables.faces.shape[1], 2, 2, 2, 3).astype(np.float32)
    return dict(jt={k: jnp.asarray(getattr(tables, k)) for k in _TABLE_KEYS},
                tt={k: T(getattr(tables, k)) for k in _TABLE_KEYS},
                cam=det["cam"], verts=det["verts"], ids=det["obj_id"].astype(np.int32), tex=tex)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _args(sc, jax_side):
    conv = jnp.asarray if jax_side else T
    return (sc["jt"] if jax_side else sc["tt"]), conv(sc["cam"]), conv(sc["verts"]), conv(sc["ids"])


def test_render_fim_wim_silhouettes_and_depth_match_jax(scene):
    with jax.default_matmul_precision("highest"):
        f2_j, fim_j, wim_j = _jit(jrend.render_fim_wim, image_size=S)(*_args(scene, True))
        sil_j = _jit(jrend.render_silhouettes, image_size=S)(*_args(scene, True))
        d_j = _jit(jrend.render_depth, image_size=S)(*_args(scene, True))
    f2_t, fim_t, wim_t = trend.render_fim_wim(*_args(scene, False), image_size=S)
    np.testing.assert_array_equal(fim_t.numpy(), np.asarray(fim_j))
    assert int((fim_t >= 0).sum()) > 50
    _close(f2_t, f2_j, 1e-5, "f2pts")
    _close(wim_t, wim_j, 1e-4, "wim")
    _close(trend.render_silhouettes(*_args(scene, False), image_size=S), sil_j, 0.0, "sil")
    _close(trend.render_depth(*_args(scene, False), image_size=S), d_j, 1e-5, "depth")


def test_encodings_flow_and_atlas_grids_match_jax(scene):
    """encode_fim, encode_sem, encode_and_warp (with the extra corners),
    cal_bc_transform, sample_from_texture_dense and sample_from_texture on
    one fim / wim, the JAX one fed to both sides."""
    with jax.default_matmul_precision("highest"):
        f2_j, fim_j, wim_j = _jit(jrend.render_fim_wim, image_size=S)(*_args(scene, True))
    ids_j, ids_t = jnp.asarray(scene["ids"]), T(scene["ids"])
    fim_t, wim_t, f2_t = T(np.array(fim_j)), T(np.array(wim_j)), T(np.array(f2_j))
    jt, tt = scene["jt"], scene["tt"]
    # the flow from the other sample's view: source = sample 1, destination 0
    flip = [1, 0]

    @jax.jit
    def jax_side(jt, ids, fim, wim, f2):
        cond = jrend.encode_and_warp(jt, ids, fim, wim)[0]
        return (jrend.encode_fim(jt, ids, fim), jrend.encode_sem(jt, ids, fim),
                jrend.encode_and_warp(jt, ids, fim, wim, f2),
                jrend.cal_bc_transform(f2[jnp.asarray(flip)], fim[jnp.asarray(flip)], fim, wim),
                jrend.sample_from_texture_dense(jt, fim, wim, ids),
                jrend.sample_from_texture(cond))

    enc_j, sem_j, warp_j, (t_j, o_j), dense_j, samp_j = jax_side(jt, ids_j, fim_j, wim_j, f2_j)
    _close(trend.encode_fim(tt, ids_t, fim_t), enc_j, 0.0)
    _close(trend.encode_sem(tt, ids_t, fim_t), sem_j, 0.0)
    for a, b in zip(trend.encode_and_warp(tt, ids_t, fim_t, wim_t, f2_t), warp_j):
        _close(a, b, 1e-6)
    t_t, o_t = trend.cal_bc_transform(f2_t[flip], fim_t[flip], fim_t, wim_t)
    _close(t_t, t_j, 1e-6, "T")
    _close(o_t, o_j, 0.0, "O")
    _close(trend.sample_from_texture_dense(tt, fim_t, wim_t, ids_t), dense_j, 1e-6)
    cond_t, _, _, _ = trend.encode_and_warp(tt, ids_t, fim_t, wim_t)
    _close(trend.sample_from_texture(cond_t), samp_j, 1e-6)


def test_texture_extraction_helpers_match_jax(scene):
    """create_coords, create_meshgrid, points_to_sampler,
    batch_orth_proj_idrot, dynamic_sampler, extract_tex and
    extract_tex_from_image, on a weak-perspective camera."""
    for t in (1, 2, 3):
        _close(trend.create_coords(t, device="cpu"), jrend.create_coords(t), 0.0, t)
    _close(trend.create_meshgrid(S, device="cpu"), jrend.create_meshgrid(S), 0.0)
    rng = np.random.RandomState(10)
    cam_weak = np.stack([rng.rand(B) * 2 + 4, rng.randn(B) * 0.01, rng.randn(B) * 0.01],
                        1).astype(np.float32)
    verts = scene["verts"] - scene["verts"].mean(1, keepdims=True)
    images = rng.rand(B, 3, S, S).astype(np.float32)

    @jax.jit
    def jax_side(jt, cam, v, ids, img):
        return (jrend.batch_orth_proj_idrot(cam, v), jrend.dynamic_sampler(jt, cam, v, ids, 3),
                jrend.extract_tex_from_image(jt, img, cam, v, ids, 3))

    with jax.default_matmul_precision("highest"):
        proj_j, sampler_j, tex_j = jax_side(scene["jt"], jnp.asarray(cam_weak),
                                            jnp.asarray(verts), jnp.asarray(scene["ids"]),
                                            jnp.asarray(images))
    _close(trend.batch_orth_proj_idrot(T(cam_weak), T(verts)), proj_j, 1e-6)
    sampler_t = trend.dynamic_sampler(scene["tt"], T(cam_weak), T(verts), T(scene["ids"]), 3)
    _close(sampler_t, sampler_j, 1e-6, "sampler")
    assert float(sampler_t.abs().max()) <= 1.0 and float(sampler_t.std()) > 0.05
    _close(trend.extract_tex_from_image(scene["tt"], T(images), T(cam_weak), T(verts),
                                        T(scene["ids"]), 3), tex_j, 1e-5, "tex")
    # extract_tex_from_image is extract_tex on dynamic_sampler's grid: the
    # port's extract_tex on the JAX grid gives the JAX cubes
    _close(trend.extract_tex(T(images), T(np.array(sampler_j)), 3), tex_j, 1e-6,
           "extract_tex")


@pytest.mark.parametrize("anti_aliasing", [True, False])
def test_render_rgb_matches_jax(scene, anti_aliasing):
    light = dict(intensity_ambient=0.4, direction=(0.3, 1.0, 0.2))
    bg = (0.1, 0.2, 0.3)
    with jax.default_matmul_precision("highest"):
        ref = _jit(jrend.render_rgb, image_size=S, anti_aliasing=anti_aliasing,
                   background_color=bg, light=light)(
            scene["jt"], jnp.asarray(scene["cam"]), jnp.asarray(scene["verts"]),
            jnp.asarray(scene["tex"]), jnp.asarray(scene["ids"]))
    out = trend.render_rgb(scene["tt"], T(scene["cam"]), T(scene["verts"]), T(scene["tex"]),
                           T(scene["ids"]), image_size=S, anti_aliasing=anti_aliasing,
                           background_color=bg, light=light)
    assert tuple(out.shape) == (B, 3, S, S)
    assert float((out - T(bg)[:, None, None]).abs().amax()) > 0.1  # the hand is in view
    _close(out, ref, 1e-4, "rgb")


# ------------------------------------------------------------ Mesh / Renderer


@pytest.mark.parametrize("mode", ["silhouettes", "soft", "depth", "rgb", "rgb_fim",
                                  "exact_silhouettes", "exact_depth", "exact_rgb"])
def test_renderer_objects_match_jax(mode):
    """Renderer's entry points, forward values (their gradients:
    tests/test_torch_rasterizer_grad.py), at 16 px with 2x anti-aliasing."""
    verts, f, _, _ = blob_scene()
    tex = np.random.RandomState(11).rand(B, f.shape[0], 2, 2, 2, 3).astype(np.float32)
    rj, rt = jnr.Renderer(image_size=16), tnr.Renderer(image_size=16)
    vj, fj, tj = jnp.asarray(verts), jnp.asarray(f), jnp.asarray(tex)
    vt, ft, tt = T(verts), T(f), T(tex)
    exact = mode.startswith("exact")
    if mode.endswith("silhouettes"):
        pair = rt.render_silhouettes(vt, ft, exact_grad=exact), jax.jit(
            lambda v, f: rj.render_silhouettes(v, f, exact_grad=exact))(vj, fj)
        atol = 0.0
    elif mode == "soft":
        pair = rt.render_silhouettes(vt, ft, soft=True), jax.jit(
            lambda v, f: rj.render_silhouettes(v, f, soft=True))(vj, fj)
        atol = 1e-6
    elif mode.endswith("depth"):
        pair = rt.render_depth(vt, ft, exact_grad=exact), jax.jit(
            lambda v, f: rj.render_depth(v, f, exact_grad=exact))(vj, fj)
        atol = 1e-5
    elif mode == "rgb_fim":
        (rgb_t, fim_t), (rgb_j, fim_j) = rt.render(vt, ft, tt, get_fim=True), jax.jit(
            lambda v, f, t: rj.render(v, f, t, get_fim=True))(vj, fj, tj)
        np.testing.assert_array_equal(fim_t.numpy(), np.asarray(fim_j))
        pair, atol = (rgb_t, rgb_j), 1e-4
    else:
        pair = rt.render(vt, ft, tt, exact_grad=exact), jax.jit(
            lambda v, f, t: rj.render(v, f, t, exact_grad=exact))(vj, fj, tj)
        atol = 1e-4
    assert float(pair[0].std()) > 0.01
    _close(*pair, atol, mode)


def test_render_mesh_and_obj_roundtrip_match_jax(tmp_path):
    """Mesh.from_obj / save_obj / render_mesh in the three modes; a mesh
    without textures renders white."""
    v, f = blob(20)
    path = str(tmp_path / "m.obj")
    jmesh.save_obj(v * 0.8, f, path)
    mt, mj = tnr.Mesh.from_obj(path, device="cpu"), jnr.Mesh.from_obj(path)
    rt, rj = tnr.Renderer(image_size=16), jnr.Renderer(image_size=16)
    for mode, atol in (("rgb", 1e-4), ("silhouettes", 0.0), ("depth", 1e-5)):
        ref = jax.jit(lambda v, f: rj.render_mesh(jnr.Mesh(v, f), mode))(mj.vertices, mj.faces)
        _close(rt.render_mesh(mt, mode), ref, atol, mode)
    mt.save_obj(str(tmp_path / "t.obj"))
    mj.save_obj(str(tmp_path / "j.obj"))
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    assert not os.path.exists(tmp_path / "t.png")  # untextured: no atlas
