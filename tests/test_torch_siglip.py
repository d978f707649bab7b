"""The port's SigLIP and its tokenizer against the JAX package's on the
same numpy inputs and weights, on the CPU (flash_single's plain version).
Ids and proto bytes equal; features, logits, preprocessing and encoders
1e-5 absolute in f32 (sums in other orders); converted leaves bit-equal.
"""
import json
import os
import string

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_slam_tpu.models import siglip as R
from vggt_slam_tpu.models import siglip_tokenizer as RT
from vggt_slam_tpu_torch.models import siglip as M
from vggt_slam_tpu_torch.models import siglip_tokenizer as T
from vggt_slam_tpu_torch.ops import attention as A

MANIFEST = os.path.join(os.path.dirname(__file__), "data",
                        "manifest_siglip_b16.json")
# (piece, score, type): 1 NORMAL, 2 UNKNOWN, 3 CONTROL, 4 USER_DEFINED,
# 5 UNUSED; f32-exact scores. "▁a b" ties "▁ab", "ab c" ties "a bc".
PIECES = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2),
          ("▁the", -1.0, 1), ("▁cat", -2.0, 1), ("▁ca", -3.0, 1),
          ("t", -1.5, 1), ("▁", -4.0, 1), ("h", -2.0, 1), ("e", -2.0, 1),
          ("▁dog", -2.25, 1), ("▁a", -1.0, 1), ("b", -1.0, 1),
          ("▁ab", -2.0, 1), ("ab", -2.0, 1), ("c", -1.5, 1),
          ("bc", -2.5, 1), ("a", -1.0, 1), ("fi", -1.0, 1), ("1", -2.0, 1),
          ("2", -2.0, 1), ("x", -2.0, 1), ("▁cat▁", -0.5, 4),
          ("▁zebra", -1.0, 5), ("<s>", 0.0, 3)]
TEXTS = {
    "ties": "ab abc aab cab",
    "unknown": "the zebra 猫 🐱 caz",
    "punctuation": "the?! cat... (dog) [a]b, it's",
    "nfkc": "ﬁ ｃａｔ ① x² ！ café",
    "whitespace": "  the\t\tcat \n dog　a\xa0b  ",
    "case": "The CAT Dog",
    "control_pieces": "<pad></s><unk> <s> the",
    "truncation": "the cat " * 10,
    "empty": "",
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_tokenizer_matches_reference(name):
    ours = T.SigLIPTokenizer(PIECES, context_length=8)
    ref = RT.SigLIPTokenizer(PIECES, context_length=8)
    assert ours.unk_score == ref.unk_score == -14.0
    text = TEXTS[name]
    assert ours.encode(text) == ref.encode(text)
    ids = ours([text, text.upper(), text[:5]])
    assert ids.dtype == np.int64 and ids.shape == (3, 8)
    np.testing.assert_array_equal(ids, ref([text, text.upper(), text[:5]]))


def test_spiece_proto_round_trips_across_packages(tmp_path):
    """Each package's writer, the other's reader; a proto with a foreign
    field and an unknown piece subfield parses alike."""
    data = T.write_spiece_model(PIECES)
    assert data == RT.write_spiece_model(PIECES)
    assert RT.parse_spiece_model(data) == PIECES
    assert T.parse_spiece_model(RT.write_spiece_model(PIECES)) == PIECES
    extra = (b"\x12\x03abc" + b"\x0a\x0b\x0a\x01t\x20\x96\x01\x15\x00\x00"
             b"\x80\xbf" + data + b"\x28\x96\x01")
    assert T.parse_spiece_model(extra) == RT.parse_spiece_model(extra) == \
        [("t", -1.0, 1)] + PIECES
    (tmp_path / "spiece.model").write_bytes(data)
    tok = T.SigLIPTokenizer.from_dir(str(tmp_path), 8)
    assert tok.encode("the cat") == [3, 4]
    with pytest.raises(FileNotFoundError):
        T.SigLIPTokenizer.from_dir(str(tmp_path / "none"))


def _ref_cfg(cfg):
    return R.SigLIPConfig(**{f: v for f, v in vars(cfg).items()
                             if f != "dtype"})


def _flax_params(cfg, seed=0, qk_gain=2.0):
    """The reference's init, q_proj and k_proj kernels scaled by qk_gain
    so that attention is not uniform."""
    model = R.SigLIP(_ref_cfg(cfg))
    params = model.init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, cfg.image_size, cfg.image_size, 3)),
        jnp.zeros((1, cfg.context_length), jnp.int32))
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * qk_gain if any(
            getattr(p, "key", None) in ("q_proj", "k_proj") for p in path)
        and path[-1].key == "kernel" else x, params)
    return model, params


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((3, cfg.image_size, cfg.image_size, 3)
                                 ).astype(np.float32)
    ids = rng.integers(0, cfg.vocab_size, (4, cfg.context_length))
    return images, ids


def test_model_matches_reference():
    cfg = M.SigLIPConfig.tiny_test()
    model, params = _flax_params(cfg)
    images, ids = _inputs(cfg)
    x, t = jnp.asarray(images), jnp.asarray(ids.astype(np.int32))
    want = model.apply(params, x, t) + (
        model.apply(params, x, normalize=False, method=R.SigLIP.encode_image),
        model.apply(params, t, normalize=False, method=R.SigLIP.encode_text))
    ours = M.load_flax_params(M.SigLIP(cfg), params["params"]).eval()
    xi, ti = torch.from_numpy(images), torch.from_numpy(ids)
    with torch.no_grad():
        got = ours(xi, ti) + (ours.encode_image(xi, normalize=False),
                              ours.encode_text(ti, normalize=False))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    # the probe's attention logits spread by more than 1 in every head
    v, H = ours.vision, cfg.vision_heads
    with torch.no_grad():
        x = v.patch_embed(xi.permute(0, 3, 1, 2)).flatten(2).transpose(
            1, 2) + v.pos_embed
        for blk in v.blocks:
            x = blk(x, causal=False)
        q = v.head.attn.q_proj(v.head.probe).view(H, -1)
        k = v.head.attn.k_proj(v.post_ln(x)).view(len(x), -1, H, q.shape[1])
        logits = torch.einsum("hd,bkhd->bhk", q, k) * q.shape[1] ** -0.5
    assert logits.std(-1).min() > 1.0


def test_attention_routes_agree_on_cpu():
    """The flash and plain routes agree in both towers, launching
    nothing."""
    cfg = M.SigLIPConfig.tiny_test()
    _, params = _flax_params(cfg, seed=3)
    model = M.load_flax_params(M.SigLIP(cfg), params["params"]).eval()
    images, ids = _inputs(cfg, seed=4)
    x, t = torch.from_numpy(images), torch.from_numpy(ids)
    before = dict(A.LAUNCHES)
    with torch.no_grad():
        flash = model.encode_image(x), model.encode_text(t)
        model.set_attn_impl("plain")
        plain = model.encode_image(x), model.encode_text(t)
    for a, b in zip(flash, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    attns = [m for m in model.modules() if isinstance(m, M.SigLIPAttention)]
    assert len(attns) == 5 and all(m.attn_impl == "plain" for m in attns)
    assert A.LAUNCHES == before


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("hw", [(20, 24), (50, 40)])
def test_preprocess_images_matches_reference(layout, hw):
    x = np.random.default_rng(hw[0]).random((2, 3) + hw).astype(np.float32)
    if layout == "nhwc":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    want = np.asarray(R.preprocess_images(x, 32))
    got = M.preprocess_images(x, 32)
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_converts_as_reference(sd, cfg):
    want = _flat(R.convert_torch_state_dict(sd, _ref_cfg(cfg)))
    got = M.convert_torch_state_dict(sd, cfg)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("source", ["seeded", "transformers"])
def test_converter_equals_reference(source):
    cfg = M.SigLIPConfig.tiny_test()
    if source == "seeded":
        sd = M.init_torch_state_dict(cfg, torch.Generator().manual_seed(0))
    else:
        transformers = pytest.importorskip("transformers")
        hf = cfg.to_hf_dict()
        torch.manual_seed(0)
        sd = transformers.SiglipModel(transformers.SiglipConfig(
            vision_config=hf["vision_config"],
            text_config=hf["text_config"])).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()
            if not k.endswith("position_ids")} == M.torch_layout(cfg)
    _assert_converts_as_reference(sd, cfg)


def _manifest():
    with open(MANIFEST) as f:
        return {k: tuple(s) for k, s in json.load(f).items()}


def test_converter_covers_the_full_scale_manifest():
    """base_patch16_224's 408 keys on the meta device: every key consumed
    into the port module's shapes."""
    cfg = M.SigLIPConfig.base_patch16_224()
    manifest = _manifest()
    assert M.torch_layout(cfg) == manifest
    assert len(manifest) == 408
    assert sum(int(np.prod(s)) for s in manifest.values()) == 203_155_970
    sd = {k: torch.empty(s, device="meta") for k, s in manifest.items()}
    sd["text_model.embeddings.position_ids"] = torch.empty(1, 64,
                                                           device="meta")
    got = M.convert_torch_state_dict(sd, cfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        M.param_shapes(cfg)


@pytest.mark.parametrize("fault", ["missing", "packed", "stray", "shape",
                                   "scalar"])
def test_converter_names_the_faulty_key(fault):
    cfg = M.SigLIPConfig.base_patch16_224()
    sd = {k: torch.empty(s, device="meta") for k, s in _manifest().items()}
    err = KeyError
    if fault == "missing":
        key = "text_model.encoder.layers.3.mlp.fc1.weight"
        del sd[key]
    elif fault == "packed":
        key = "vision_model.head.attention.in_proj_bias"
        del sd[key]
    elif fault == "stray":
        key = "rogue.weight"
        sd[key] = torch.empty(3)
    elif fault == "shape":
        err, key = ValueError, "vision_model.post_layernorm.weight"
        sd[key] = torch.empty(512, device="meta")
    else:
        err, key = ValueError, "logit_bias"
        sd[key] = torch.empty((), device="meta")
    with pytest.raises(err, match=key):
        M.convert_torch_state_dict(sd, cfg)


def write_checkpoint(d, cfg, fmt, seed=0):
    """A SigLIP checkpoint directory of seeded weights and a spiece.model
    covering lowercase ASCII and digits."""
    sd = M.init_torch_state_dict(cfg, torch.Generator().manual_seed(seed),
                                 std=0.1)
    if fmt == "bin":
        torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    else:
        from safetensors.torch import save_file
        save_file(sd, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg.to_hf_dict(), f)
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2)]
    pieces += [("▁" + w, -1.0, 1)
               for w in ("the", "cat", "dog", "a", "photo", "of")]
    pieces += [(c, -5.0, 1) for c in string.ascii_lowercase + string.digits]
    pieces += [("▁", -4.0, 1)]
    with open(os.path.join(d, "spiece.model"), "wb") as f:
        f.write(T.write_spiece_model(pieces[:cfg.vocab_size]))
    return sd


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_encoders_match_reference(tmp_path, fmt):
    if fmt == "safetensors":
        pytest.importorskip("safetensors")
    cfg = M.SigLIPConfig.tiny_test()
    write_checkpoint(str(tmp_path), cfg, fmt)
    crops_p, text_p = M.make_encoders(str(tmp_path), max_batch=32,
                                      device="cpu")
    crops_r, text_r = R.make_encoders(str(tmp_path), max_batch=32)
    rng = np.random.default_rng(2)
    crops = rng.random((70, 3, 40, 40)).astype(np.float32)
    at_size = rng.random((5, 32, 32, 3)).astype(np.float32)
    texts = ["the cat", "a photo of a dog!", "dog 42", "Zebra", ""]
    for got, want in ((crops_p(crops), crops_r(crops)),
                      (crops_p(at_size), crops_r(at_size)),
                      (text_p(texts), text_r(texts))):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0,
                                   atol=1e-5)
    assert crops_p(crops[:0]).shape == (0, cfg.projection_size)
    assert text_p([]).shape == (0, cfg.projection_size)
    assert crops_p.model is text_p.model


def test_encoders_need_the_card_unless_the_cpu_is_asked_for(tmp_path,
                                                            monkeypatch):
    from vggt_slam_tpu_torch.semantic.embedder import resolve_clip_encoders

    cfg = M.SigLIPConfig.tiny_test()
    write_checkpoint(str(tmp_path), cfg, "bin")
    crops, _ = resolve_clip_encoders(str(tmp_path), "native", "cpu")
    assert isinstance(crops.model, M.SigLIP)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_encoders(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_clip_encoders(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        M.load_torch_checkpoint(str(tmp_path / "nothing"), cfg)
