"""The port's VGGT torch-checkpoint converter against the reference's on the
same state dicts: arrays bit-equal (rope permutation, pos_embed fold,
transposes) and the same report; the VGGT-1B manifest covered on the meta
device; bf16 tensors; the `model.pt` helper's npz.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_slam_tpu.models.vggt import convert as JC
from vggt_slam_tpu.models.vggt.config import VGGTConfig as JConfig
from vggt_slam_tpu.models.vggt.model import VGGT as JVGGT
from vggt_slam_tpu_torch.models.vggt import convert as TC
from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig
from vggt_slam_tpu_torch.models.vggt.model import VGGT

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
EXTRA_KEYS = {"aggregator.patch_embed.mask_token": (1, 32),
              "aggregator._resnet_mean": (1, 3, 1, 1),
              "track_head.proj.weight": (4, 8)}


def _torch_layout(name: str, arr: np.ndarray) -> np.ndarray:
    """A flax-layout array -> the released checkpoint's layout (the
    inverse of the converter's transforms, rope order aside)."""
    if name.endswith(".weight") and arr.ndim == 4:
        if ".resize_layers.0." in name or ".resize_layers.1." in name:
            return arr.transpose(2, 3, 0, 1)    # (k, k, in, out) -> torch
        return arr.transpose(3, 2, 0, 1)        # HWIO -> OIHW
    if name.endswith(".weight") and arr.ndim == 2:
        return arr.T
    if name.endswith("pos_embed"):
        g, C = arr.shape[1], arr.shape[3]
        return np.concatenate([np.full((1, 1, C), 0.25, arr.dtype),
                               arr.reshape(1, g * g, C)], axis=1)
    if name in ("aggregator.camera_token", "aggregator.register_token"):
        return arr[None]
    return arr


@pytest.fixture(scope="module")
def tiny_case():
    cfg = JConfig.tiny()
    shapes = jax.eval_shape(JVGGT(cfg).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 3, 56, 56), jnp.float32))
    jtemplate = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    rng = np.random.default_rng(11)
    sd = {}
    for path, arr in JC._flatten(jtemplate).items():
        name = JC._torch_name_candidates(path)[0]
        sd[name] = torch.from_numpy(_torch_layout(
            name, rng.normal(size=arr.shape).astype(np.float32)))
    for name, shape in EXTRA_KEYS.items():
        sd[name] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return sd, jtemplate


def test_tiny_state_dict_converts_bit_equal(tiny_case):
    sd, jtemplate = tiny_case
    jparams, jreport = JC.convert_torch_state_dict(dict(sd), jtemplate)
    tsd, treport = TC.convert_torch_state_dict(
        dict(sd), TC.meta_template(VGGT, VGGTConfig.tiny()))
    want = JC._flatten(jparams)
    got = {TC.torch_key_to_flax(k): v.numpy() for k, v in tsd.items()}
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype == np.float32
        np.testing.assert_array_equal(got[path], arr, err_msg=path)
    assert sorted(treport["unmatched_flax"]) == sorted(
        jreport["unmatched_flax"]) == []
    assert treport["unused_torch"] == jreport["unused_torch"] == sorted(
        EXTRA_KEYS)
    assert all(TC.allowed_unused_vggt(k) for k in treport["unused_torch"])
    # the rope blocks' q rows really were permuted (not the identity)
    qkv = "aggregator.frame_blocks.0.attn.qkv.weight"
    assert not np.array_equal(
        tsd["aggregator.frame_block_0.attn.qkv.kernel"].numpy(),
        sd[qkv].numpy().T)


def test_torch_checkpoint_to_npz_matches_reference(tiny_case, tmp_path):
    """`convert_torch_checkpoint` unwraps {"model": ...} and writes the
    reference's flat npz: the same keys and bit-equal arrays."""
    sd, jtemplate = tiny_case
    pt = str(tmp_path / "model.pt")
    torch.save({"model": sd, "epoch": 3}, pt)
    JC.convert_torch_checkpoint(pt, jtemplate, str(tmp_path / "ref.npz"))
    report = TC.convert_torch_checkpoint(pt, str(tmp_path / "port.npz"),
                                         VGGTConfig.tiny())
    assert report["unmatched_flax"] == []
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") \
            as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    model = VGGT(VGGTConfig.tiny())
    model.load_state_dict(TC.load_checkpoint(str(tmp_path / "port.npz")),
                          strict=True)


def test_vggt_1b_manifest_coverage_on_meta_template():
    """Every parameter of the port's VGGT-1B fills from the released
    checkpoint's keys and shapes (zero tensors broadcast from the
    manifest: no memory), and only the allowlisted keys stay unused."""
    with open(os.path.join(DATA_DIR, "manifest_vggt_1b.json")) as f:
        manifest = json.load(f)
    sd = {k: torch.zeros(()).expand(s) for k, s in manifest.items()}
    template = TC.meta_template(VGGT, VGGTConfig.vggt_1b())
    out, report = TC.convert_torch_state_dict(sd, template)
    assert report["unmatched_flax"] == []
    assert [k for k in report["unused_torch"]
            if not TC.allowed_unused_vggt(k)] == []
    assert report["unused_torch"]
    assert sorted(out) == sorted(template)
    assert all(out[k].shape == p.shape for k, p in template.items())


def test_bf16_tensor_converts_like_reference():
    t = torch.randn(4, 8, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    jparams, _ = JC.convert_torch_state_dict(
        {"head.weight": t}, {"head": {"kernel": jnp.zeros((8, 4))}})
    sd, report = TC.convert_torch_state_dict(
        {"head.weight": t}, {"head.kernel": torch.empty(8, 4,
                                                         device="meta")})
    assert report == {"unmatched_flax": [], "unused_torch": []}
    np.testing.assert_array_equal(sd["head.kernel"].numpy(),
                                  t.float().numpy().T)
    np.testing.assert_array_equal(sd["head.kernel"].numpy(),
                                  np.asarray(jparams["head"]["kernel"]))


def test_unmatched_parameters_are_reported_as_zeros():
    sd, report = TC.convert_torch_state_dict(
        {"head.weight": torch.ones(3, 3)},
        {"head.kernel": torch.empty(4, 3, device="meta")})
    assert report == {"unmatched_flax": ["params/head/kernel"],
                      "unused_torch": ["head.weight"]}
    assert not sd["head.kernel"].any()
