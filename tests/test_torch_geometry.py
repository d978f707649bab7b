"""The port's geometry and solvers (ops: lie, geometry, homography,
pose_graph) against the JAX reference on the CPU: f64 1e-9, f32 5e-5
relative to the values' scale, the pose graph 1e-6 (a converged f64 LM).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_slam_tpu.ops import geometry as jgeo
from vggt_slam_tpu.ops import homography as jhom
from vggt_slam_tpu.ops import lie as jlie
from vggt_slam_tpu_torch.ops import geometry as tgeo
from vggt_slam_tpu_torch.ops import homography as thom
from vggt_slam_tpu_torch.ops import lie as tlie

jax.config.update("jax_enable_x64", True)

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 5e-5),
          "f64": (np.float64, jnp.float64, torch.float64, 1e-9)}


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale,
                               rtol=0)


def _sl4(rng, n, scale=0.3):
    xi = rng.normal(size=(n, 15)) * scale
    return np.asarray(jlie.sl4_exp(jnp.asarray(xi, jnp.float64)))


LIE_FUNCS = {
    # name: (input maker (rng, np dtype) -> array, jax fn, torch fn)
    "quat_to_rotmat": (lambda r, d: r.normal(size=(6, 4)).astype(d),
                       jlie.quat_to_rotmat, tlie.quat_to_rotmat),
    "rotmat_to_quat": (lambda r, d: np.asarray(jlie.so3_exp(jnp.asarray(
        r.normal(size=(6, 3)) * 1.5))).astype(d),
        jlie.rotmat_to_quat, tlie.rotmat_to_quat),
    "so3_log": (lambda r, d: np.asarray(jlie.so3_exp(jnp.asarray(
        r.normal(size=(6, 3))))).astype(d), jlie.so3_log, tlie.so3_log),
    "se3_exp": (lambda r, d: r.normal(size=(6, 6)).astype(d),
                jlie.se3_exp, tlie.se3_exp),
    "se3_log": (lambda r, d: np.asarray(jlie.se3_exp(jnp.asarray(
        r.normal(size=(6, 6)) * 0.5))).astype(d), jlie.se3_log,
        tlie.se3_log),
    "se3_inverse": (lambda r, d: np.asarray(jlie.se3_exp(jnp.asarray(
        r.normal(size=(6, 6))))).astype(d), jlie.se3_inverse,
        tlie.se3_inverse),
    "sim3_exp": (lambda r, d: r.normal(size=(6, 7)).astype(d) * 0.5,
                 jlie.sim3_exp, tlie.sim3_exp),
    "sim3_log": (lambda r, d: np.asarray(jlie.sim3_exp(jnp.asarray(
        r.normal(size=(6, 7)) * 0.4))).astype(d), jlie.sim3_log,
        tlie.sim3_log),
    "inv44": (lambda r, d: _sl4(r, 6).astype(d), jlie.inv44, tlie.inv44),
    "expm_with_squarings": (lambda r, d: (r.normal(size=(6, 4, 4))
                                          * 1.5).astype(d),
                            jlie.expm, tlie.expm),
    "sl4_exp": (lambda r, d: (r.normal(size=(6, 15)) * 0.3).astype(d),
                jlie.sl4_exp, tlie.sl4_exp),
    "sl4_log": (lambda r, d: _sl4(r, 6).astype(d), jlie.sl4_log,
                tlie.sl4_log),
    "sl4_normalize": (lambda r, d: (r.normal(size=(6, 4, 4))
                                    + 3 * np.eye(4)).astype(d),
                      jlie.sl4_normalize, tlie.sl4_normalize),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(LIE_FUNCS))
def test_lie_matches_reference(name, dtype):
    npd, jd, td, tol = DTYPES[dtype]
    make, jfn, tfn = LIE_FUNCS[name]
    x = make(np.random.default_rng(0), npd)
    want = jfn(jnp.asarray(x, jd))
    got = tfn(torch.from_numpy(x))
    assert got.dtype == td
    _close(got.numpy(), want, tol * (20 if name.startswith(("sl4_log",
                                                            "sim3_log"))
                                     and dtype == "f32" else 1))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_homography_matches_reference(dtype):
    npd, jd, _, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    H = _sl4(rng, 3, 0.1).astype(npd)
    X = rng.normal(size=(3, 50, 3)).astype(npd)
    want = jlie.apply_homography(jnp.asarray(H, jd), jnp.asarray(X, jd))
    _close(tlie.apply_homography(torch.from_numpy(H),
                                 torch.from_numpy(X)).numpy(), want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_camera_geometry_matches_reference(dtype):
    npd, jd, _, tol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    S, H, W = 3, 12, 17
    enc = np.concatenate([rng.normal(size=(S, 3)), rng.normal(size=(S, 4)),
                          rng.uniform(0.6, 1.2, size=(S, 2))], 1).astype(npd)
    depth = rng.uniform(0.5, 3.0, size=(S, H, W)).astype(npd)
    je, ji = jgeo.pose_encoding_to_extri_intri(jnp.asarray(enc, jd), (H, W))
    te, ti = tgeo.pose_encoding_to_extri_intri(torch.from_numpy(enc), (H, W))
    _close(te.numpy(), je, tol)
    _close(ti.numpy(), ji, tol)
    jd_ = jnp.asarray(depth, jd)
    _close(tgeo.unproject_depth_map_to_point_map_cf(
        torch.from_numpy(depth), te, ti).numpy(),
        jgeo.unproject_depth_map_to_point_map_cf(jd_, je, ji), tol)
    _close(tgeo.unproject_depth_map_to_point_map(
        torch.from_numpy(depth), te, ti).numpy(),
        jgeo.unproject_depth_map_to_point_map(jd_, je, ji), tol)
    c2w = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(size=(S, 6))
                                              * 0.3))).astype(npd)
    Hw = _sl4(rng, 1, 0.05)[0].astype(npd)
    want = jgeo.poses_world_from_submap(ji, jnp.asarray(c2w, jd),
                                        jnp.asarray(Hw, jd))
    got = tgeo.poses_world_from_submap(ti, torch.from_numpy(c2w),
                                       torch.from_numpy(Hw))
    _close(got.numpy(), want, tol * 10)


def _ransac_problem(rng, n=400, outliers=0.3):
    H = _sl4(rng, 1, 0.08)[0]
    X1 = rng.uniform(-2, 2, size=(n, 3))
    X2 = np.asarray(jlie.apply_homography(jnp.asarray(H),
                                          jnp.asarray(X1)))
    X2 = X2 + rng.normal(size=X2.shape) * 1e-3
    bad = rng.uniform(size=n) < outliers
    X2[bad] = rng.uniform(-2, 2, size=(int(bad.sum()), 3))
    w = (rng.uniform(size=n) > 0.1).astype(np.float64)
    idx = rng.choice(n, size=(300, 5), p=w / w.sum())
    return H, X1, X2, w, idx


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ransac_with_injected_indices_matches_reference(dtype):
    """The same 300 five-point samples through both RANSACs: the batched
    DLT/SVD, the identity fallbacks and the weighted inlier argmax."""
    npd, jd, _, _ = DTYPES[dtype]
    H_true, X1, X2, w, idx = _ransac_problem(np.random.default_rng(3))
    X1, X2, w = X1.astype(npd), X2.astype(npd), w.astype(npd)
    jX1, jX2, jw = (jnp.asarray(a, jd) for a in (X1, X2, w))
    H_ests = jhom.estimate_3d_homography(jX1[idx], jX2[idx])
    err = jnp.linalg.norm(jlie.apply_homography(H_ests, jX1[None]) - jX2[None],
                          axis=-1)
    inl = ((jnp.where(jnp.isfinite(err), err, jnp.inf) < 0.01)
           * jw[None]).sum(-1)
    H_t, count = thom.ransac_projective(
        torch.from_numpy(X1), torch.from_numpy(X2), torch.from_numpy(w),
        indices=torch.from_numpy(idx))
    assert float(count) == float(inl.max())
    np.testing.assert_allclose(H_t.numpy(),
                               np.asarray(H_ests[int(jnp.argmax(inl))]),
                               atol=1e-4 if dtype == "f32" else 1e-9)
    H_n = H_t.numpy() / np.cbrt(np.linalg.det(H_t.numpy())) ** 0.75
    assert np.abs(H_n / H_n[3, 3] - H_true / H_true[3, 3]).max() < 0.05


def test_ransac_sampled_recovers_homography_and_degenerate_is_identity():
    H_true, X1, X2, w, _ = _ransac_problem(np.random.default_rng(4))
    gen = torch.Generator().manual_seed(0)
    H, count = thom.ransac_projective(torch.from_numpy(X1),
                                      torch.from_numpy(X2),
                                      torch.from_numpy(w), generator=gen)
    Hn = H.numpy()
    assert np.abs(Hn / Hn[3, 3] - H_true / H_true[3, 3]).max() < 0.05
    assert float(count) > 0.5 * w.sum()
    flat = np.random.default_rng(5).uniform(size=(2, 5, 3))
    flat[..., 2] = 0.0                       # coplanar: rank-deficient DLT
    got = thom.estimate_3d_homography(torch.from_numpy(flat),
                                      torch.from_numpy(flat))
    want = jhom.estimate_3d_homography(jnp.asarray(flat), jnp.asarray(flat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.tile(np.eye(4), (2, 1, 1)))


def _graph_arrays(rng):
    """A 4-node SL(4) chain, 3 odometry factors + 1 loop factor, a tight
    prior on node 0, noisy initial values; f64 numpy fields of
    GraphArrays (capacities 4 nodes / 4 factors / 1 prior)."""
    rel = [_sl4(rng, 1, 0.1)[0] for _ in range(3)]
    gt = [np.eye(4)]
    for H in rel:
        gt.append(gt[-1] @ H)
    init = np.stack([gt[0]] + [H @ _sl4(rng, 1, 0.02)[0] for H in gt[1:]])
    meas = np.stack(rel + [gt[3]])
    return gt, dict(
        values=init, node_mask=np.ones(4, bool),
        bet_i=np.array([0, 1, 2, 0]), bet_j=np.array([1, 2, 3, 3]),
        bet_meas=meas, bet_sqrt_info=np.full((4, 15), 1 / 0.05),
        bet_mask=np.ones(4, bool), pri_node=np.array([0]),
        pri_meas=np.eye(4)[None], pri_sqrt_info=np.full((1, 15), 1e6),
        pri_mask=np.ones(1, bool))


@pytest.mark.slow   # ~30 s: XLA compiles the reference's LM on the CPU
def test_pose_graph_optimize_matches_reference():
    """The port's LM (jacfwd under vmap, dense Cholesky, the damping loop)
    reaches the reference's solution from the same graph."""
    from vggt_slam_tpu.ops import pose_graph as jpg
    from vggt_slam_tpu_torch.ops import pose_graph as tpg

    gt, fields = _graph_arrays(np.random.default_rng(6))
    jv, jerr = jpg.optimize(jpg.GraphArrays(
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    tv, terr = tpg.optimize(tpg.GraphArrays(
        **{k: torch.as_tensor(v) for k, v in fields.items()}))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(float(terr), float(jerr), atol=1e-9)
    for i in range(4):
        want = gt[i] / np.abs(np.linalg.det(gt[i])) ** 0.25
        np.testing.assert_allclose(tv[i].numpy(), want, atol=1e-5)
