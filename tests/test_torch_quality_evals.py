"""retrieval_quality and ab_attention against the JAX package's: scores,
summaries, paired deltas, run's counts equal; tiny descriptors 1e-5,
random SALAD on the JAX init's weights 1e-4, the gate 1e-6 on pinned
RANSAC samples; run_config's command and rows.
"""
import argparse
import csv
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from vggt_slam_tpu.evals import ab_attention as JA
from vggt_slam_tpu.evals import retrieval_quality as JQ
from vggt_slam_tpu_torch.evals import ab_attention as TA
from vggt_slam_tpu_torch.evals import retrieval_quality as TQ

SEQ = (7_000_000, 24, (49, 64))


@pytest.fixture(scope="module")
def seq():
    return JQ.render_sequence(*SEQ)


@pytest.mark.parametrize("gated", [False, True])
def test_score_sequence_and_summarize_match_reference(gated):
    rng = np.random.default_rng(5)
    desc = rng.normal(size=(40, 16)).astype(np.float32) * 0.15
    desc[30:] = desc[:10] + 0.01 * rng.normal(size=(10, 16))
    centers = rng.uniform(0, 0.3, (40, 3))
    rots = Rotation.random(40, random_state=5).as_matrix()

    def gate(qi, mi):
        return ((qi * 7 + mi * 3) % 11) / 8.0

    args = (desc, centers, rots, 8, 0.8, 0.15, 40.0)
    want = JQ.score_sequence(*args, gate_fn=gate if gated else None)
    got = TQ.score_sequence(*args, gate_fn=gate if gated else None)
    assert got == want and want["accepted"] > 0
    rows = [{"backend": b, "sequence": s, **want} for b in ("x", "y")
            for s in range(2)]
    assert TQ.summarize(rows) == JQ.summarize(rows)


def test_tiny_descriptors_and_run_counts_match_reference(seq):
    frames = seq[0]
    got = TQ.make_backend("tiny", "cpu")(frames)
    np.testing.assert_allclose(got, JQ.make_backend("tiny")(frames),
                               atol=1e-5)
    keys = ("queries", "gt_revisit_queries", "accepted", "true_accepted",
            "top1_accepted", "top1_true")
    kw = dict(n_sequences=1, n_frames=SEQ[1], image_hw=SEQ[2], submap_size=4)
    want = JQ.run(["tiny"], **kw)[0]
    got = TQ.run(["tiny"], device="cpu", **kw)[0]
    assert want["accepted"] > 0
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


def test_salad_random_matches_reference_on_its_weights(seq, monkeypatch):
    from vggt_slam_tpu.models import retrieval as JR
    from vggt_slam_tpu.models.vggt import convert as JC
    from vggt_slam_tpu_torch.models import retrieval as TR
    from vggt_slam_tpu_torch.models.vggt import convert as TC

    params = jax.jit(JR.SALAD(JR.SALADConfig.tiny()).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 224, 224)))
    sd = TC.load_flax_params(JC._flatten(params))
    monkeypatch.setattr(TR, "init_params", lambda cfg, gen, dev: sd)
    frames = seq[0][:6]
    want = JQ.make_backend("salad_random")(frames)
    got = TQ.make_backend("salad_random", "cpu")(frames)
    assert got.shape == (6, 16 + 8 * 16)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_geometric_gate_matches_reference_on_pinned_samples(seq,
                                                            monkeypatch):
    """Each pair's samples from its seed (PRNGKey, the generator)."""
    from vggt_slam_tpu_torch.ops import homography as TH

    def pinned(seed, n):
        return np.random.default_rng(seed).integers(0, n, (300, 5))

    monkeypatch.setattr(jax.random, "choice", lambda key, n, shape, replace,
                        p: jnp.asarray(pinned(int(key[-1]), n)))
    monkeypatch.setattr(TH, "sample_indices", lambda w, gen, *a: torch.
                        as_tensor(pinned(gen.initial_seed(), len(w))))
    _, _, _, depths, K = seq
    pairs = [(20, 2), (23, 1), (12, 12), (16, 5)]
    with jax.disable_jit():
        gate = JQ.make_gate_fn(depths, K, seed=3)
        want = [gate(*p) for p in pairs]
    gate = TQ.make_gate_fn(depths, K, seed=3, device="cpu")
    got = [gate(*p) for p in pairs]
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert len(set(np.round(want, 6))) > 1


def test_ab_summaries_and_paired_deltas_match_reference():
    rng = np.random.default_rng(2)
    rows = [{"config": c, "sequence": f"seq{s:03d}", "trial": "0",
             "ate_rmse": str(round(rng.uniform(0.1, 0.5), 6)),
             "ate_scale": str(round(rng.uniform(0.5, 2), 4))}
            for c in ("exact_online", "merged8_static", "exact_chunked")
            for s in range(5)]
    rows[3]["ate_rmse"] = ""
    assert TA.summarize(rows) == JA.summarize(rows)
    for base in ("exact_online", "exact_chunked", "missing"):
        assert TA.paired_deltas(rows, base, n_boot=500) == \
            JA.paired_deltas(rows, base, n_boot=500)
    assert TA.CONFIGS == JA.CONFIGS


@pytest.mark.parametrize("impl", [None, "chunked"])
def test_ab_run_config_command_and_rows(tmp_path, monkeypatch, impl):
    written = {}

    def fake_run(cmd, **kw):
        out = cmd[cmd.index("--out") + 1]
        with open(out, "w", newline="") as f:
            w = csv.DictWriter(f, ["sequence", "trial", "ate_rmse"])
            w.writeheader()
            w.writerows([{"sequence": "seq000", "trial": 0,
                          "ate_rmse": 0.25}])
        written.setdefault(cmd[2], []).append(list(cmd))
        return argparse.Namespace(returncode=0, stdout="ok\n", stderr="")

    for mod in (JA, TA):
        monkeypatch.setattr(mod.subprocess, "run", fake_run)
    got = []
    for mod, sub in ((JA, "ref"), (TA, "port")):
        args = argparse.Namespace(
            out=str(tmp_path / sub / "ab.csv"), trials=1, submap_size=8,
            min_disparity=20, conf_threshold=25, model_size="small",
            loop_inlier_thresh=0.0, checkpoint="ck.npz", attn_impl=None,
            device="cpu")
        got.append(mod.run_config("merged8_static", 8, "static", impl,
                                  str(tmp_path), [str(tmp_path / "seq000")],
                                  args))
    assert got[0] == got[1] and got[1][0]["config"] == "merged8_static"
    (ref,), (port,) = (written["vggt_slam_tpu.evals.run_eval"],
                       written["vggt_slam_tpu_torch.evals.run_eval"])
    ref[2] = port[2]
    i = port.index("--device")
    assert port[i:i + 2] == ["--device", "cpu"]
    assert [c.replace("/ref/", "/port/") for c in ref] == \
        port[:i] + port[i + 2:]
    assert port[0] == sys.executable
