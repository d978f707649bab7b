"""The port's CLIP and its tokenizer (vggt_slam_tpu_torch/models/clip.py,
models/clip_tokenizer.py) against the JAX package's, on the same numpy
inputs and the same weights, on the CPU (where the vision tower's
flash_single takes its plain version).

Tolerances: tokens and ids equal; the tokenizer's split equal to CLIP's
pattern under the `regex` package; features and logits 1e-5 absolute in
f32 (the two sides sum in other orders: ~3e-7 on features, ~4e-6 on
logits, which carry exp(logit_scale) ~ 14); `preprocess_images` 1e-5
(F.interpolate with antialias against jax.image.resize, ~7e-7 apart);
converted leaves bit-equal; encoders 1e-5; the safetensors reader
bit-equal to the safetensors package.
"""
import json
import os
import random
import unicodedata

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_slam_tpu.models import clip as R
from vggt_slam_tpu.models import clip_tokenizer as RT
from vggt_slam_tpu_torch.models import clip as M
from vggt_slam_tpu_torch.models import clip_tokenizer as T

MANIFEST = os.path.join(os.path.dirname(__file__), "data",
                        "manifest_clip_vit_b32.json")
MERGES = ["t h", "th e</w>", "a n", "an d</w>", "c a", "ca t</w>", "d o",
          "do g</w>", "1 2", "' s</w>"]


def write_vocab(d):
    """A vocab/merges pair in the released files' format: the 256 byte
    symbols, their `</w>` forms, the merged tokens, then the specials."""
    vocab = list(T.bytes_to_unicode().values())
    vocab += [v + "</w>" for v in vocab]
    vocab += ["".join(m.split()) for m in MERGES]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({tok: i for i, tok in enumerate(vocab)}, f)
    with open(os.path.join(d, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    return len(vocab)


TEXTS = {
    "accents": "Café naïve café naïve é́ xͅy",
    "cjk": "中文 cat 日本語の猫 한국어",
    "numbers": "12 dogs, 2024! ½ cup ٣ apples Ⅻ x² 3.5",
    "contractions": "IT'S the DOG'S toy; we'LL they'Re I'M she'd 've 'ſ",
    "symbols": "snake_case __init__ 🐱🐶!! a+b=c (x) [y] #1 @you ~/.",
    "specials": "a <|endoftext|> b !<|startoftext|>",
    "whitespace": "tabs\tand\nnewlines\r\n  and　ideographic sep",
    "control": "ctrl\x00\x07\x1b chars\x1c\x1d zero​width �",
    "long": "the cat and the dog " * 12,
    "empty": "",
}


@pytest.fixture
def vocab_dir(tmp_path):
    write_vocab(str(tmp_path))
    return str(tmp_path)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_tokenizer_matches_reference(vocab_dir, name):
    text = TEXTS[name]
    ours = T.CLIPTokenizer.from_dir(vocab_dir, 16)
    ref = RT.CLIPTokenizer.from_dir(vocab_dir, 16)
    assert ours.tokenize(text) == ref.tokenize(text)
    ids = ours([text, text.upper()])
    assert ids.dtype == np.int64 and ids.shape == (2, 16)
    np.testing.assert_array_equal(ids, ref([text, text.upper()]))


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_tokenizer_matches_transformers(vocab_dir, name):
    transformers = pytest.importorskip("transformers")
    text = TEXTS[name]
    theirs = transformers.CLIPTokenizer(os.path.join(vocab_dir, "vocab.json"),
                                        os.path.join(vocab_dir, "merges.txt"))
    ours = T.CLIPTokenizer.from_dir(vocab_dir, 16)
    if name == "specials":
        # transformers splits the special tokens out of the text first; the
        # reference (and so the port) byte-encodes them as any other text
        assert "<|endoftext|>" in theirs.tokenize(text)
        assert "<|endoftext|>" not in ours.tokenize(text)
        return
    assert ours.tokenize(text) == theirs.tokenize(text)
    want = theirs([text], padding="max_length", max_length=16,
                  truncation=True)["input_ids"][0]
    np.testing.assert_array_equal(ours([text])[0], want)


def test_split_matches_the_pattern():
    """The scanner against RT._PAT (IGNORECASE) under `regex`, on random
    strings of the pattern's literals and of characters whose L and N
    classes agree between Python's and `regex`'s Unicode versions."""
    regex = pytest.importorskip("regex")
    pat = regex.compile(RT._PAT, regex.IGNORECASE)

    def agrees(ch):
        cat = unicodedata.category(ch)
        return (bool(regex.match(r"\p{L}", ch)) == cat.startswith("L")
                and bool(regex.match(r"\p{N}", ch)) == cat.startswith("N"))

    pool = [chr(c) for c in list(range(0x2600)) + list(range(0x3000, 0x3100))
            + list(range(0x1F300, 0x1F700)) if agrees(chr(c))]
    lits = (["<|startoftext|>", "<|endoftext|>", "'s", "'LL", "'rE", "'ſ",
             "ͅ", "_", " ", "\t", "\x1c"] + list("'sStTrRvVmMlLdD<|>"))
    rng = random.Random(0)
    for _ in range(3000):
        s = "".join(rng.choice(lits) if rng.random() < 0.5
                    else rng.choice(pool) for _ in range(rng.randint(0, 16)))
        assert T.split(s) == pat.findall(s), repr(s)


def _ref_cfg(cfg):
    """The JAX package's CLIPConfig with the port config's fields."""
    return R.CLIPConfig(**{f: v for f, v in vars(cfg).items()
                           if f != "dtype"})


def _flax_params(cfg, seed=0):
    model = R.CLIP(_ref_cfg(cfg))
    ids = jnp.zeros((1, cfg.context_length), jnp.int32)
    img = jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
    return model, model.init(jax.random.PRNGKey(seed), img, ids)


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((3, cfg.image_size, cfg.image_size, 3)
                                 ).astype(np.float32)
    eos = cfg.vocab_size - 1
    ids = np.full((4, cfg.context_length), eos, np.int64)
    for i in range(4):
        n = int(rng.integers(3, cfg.context_length + 1))
        ids[i, :n - 1] = rng.integers(1, eos - 1, size=n - 1)
    return images, ids


def test_model_matches_reference():
    cfg = M.CLIPConfig.tiny_test()
    model, params = _flax_params(cfg)
    images, ids = _inputs(cfg)
    logits, img, txt = model.apply(params, jnp.asarray(images),
                                   jnp.asarray(ids.astype(np.int32)))
    raw = model.apply(params, jnp.asarray(images), normalize=False,
                      method=R.CLIP.encode_image)
    ours = M.load_flax_params(M.CLIP(cfg), params["params"]).eval()
    with torch.no_grad():
        got = ours(torch.from_numpy(images), torch.from_numpy(ids))
        got_raw = ours.encode_image(torch.from_numpy(images), normalize=False)
    for a, b in zip(got + (got_raw,), (logits, img, txt, raw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_vision_attention_routes_agree_on_cpu():
    """The default route (flash_single, its plain version on the CPU) and
    attn_impl="plain" give the same features; the plain route launches
    nothing and the default one is flash_single_ref's function."""
    cfg = M.CLIPConfig.tiny_test()
    _, params = _flax_params(cfg, seed=3)
    model = M.load_flax_params(M.CLIP(cfg), params["params"]).eval()
    images, _ = _inputs(cfg, seed=4)
    x = torch.from_numpy(images)
    with torch.no_grad():
        flash = model.encode_image(x)
        model.set_attn_impl("plain")
        plain = model.encode_image(x)
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), rtol=0,
                               atol=1e-6)
    assert all(m.attn_impl == "plain" for m in model.vision.modules()
               if isinstance(m, M.CLIPAttention))


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("hw", [(32, 32), (20, 24), (50, 40)])
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


def test_converter_equals_reference_on_a_transformers_model():
    transformers = pytest.importorskip("transformers")
    cfg = M.CLIPConfig.tiny_test()
    hf = transformers.CLIPConfig(projection_dim=cfg.projection_dim,
                                 vision_config=cfg.to_hf_dict()[
                                     "vision_config"],
                                 text_config=cfg.to_hf_dict()["text_config"])
    torch.manual_seed(0)
    sd = transformers.CLIPModel(hf).state_dict()
    want = _flat(R.convert_torch_state_dict(sd, _ref_cfg(cfg)))
    got = M.convert_torch_state_dict(sd, cfg)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert {k: tuple(v.shape) for k, v in sd.items()
            if not k.endswith("position_ids")} == M.torch_layout(cfg)


def _manifest():
    with open(MANIFEST) as f:
        return {k: tuple(s) for k, s in json.load(f).items()}


def test_converter_covers_the_full_scale_manifest():
    """ViT-B/32's 398 keys (151,277,313 values) on the meta device: every
    key consumed, every leaf the port module's shape."""
    cfg = M.CLIPConfig.base_patch32()
    manifest = _manifest()
    assert M.torch_layout(cfg) == manifest
    assert sum(int(np.prod(s)) for s in manifest.values()) == 151_277_313
    sd = {k: torch.empty(s, device="meta") for k, s in manifest.items()}
    sd["text_model.embeddings.position_ids"] = torch.empty(1, 77,
                                                           device="meta")
    got = M.convert_torch_state_dict(sd, cfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        M.param_shapes(cfg)


@pytest.mark.parametrize("fault", ["missing", "stray", "shape"])
def test_converter_names_the_faulty_key(fault):
    cfg = M.CLIPConfig.base_patch32()
    sd = {k: torch.empty(s, device="meta") for k, s in _manifest().items()}
    if fault == "missing":
        del sd["text_model.encoder.layers.7.mlp.fc1.bias"]
        err, key = KeyError, "layers.7.mlp.fc1.bias"
    elif fault == "stray":
        sd["vision_model.sneaky_extra.weight"] = torch.empty(3)
        err, key = KeyError, "sneaky_extra"
    else:
        sd["visual_projection.weight"] = torch.empty(512, 512, device="meta")
        err, key = ValueError, "visual_projection.weight"
    with pytest.raises(err, match=key):
        M.convert_torch_state_dict(sd, cfg)


def write_checkpoint(d, cfg, fmt, seed=0):
    """A transformers-style checkpoint directory of seeded weights."""
    sd = M.init_torch_state_dict(cfg, torch.Generator().manual_seed(seed),
                                 std=0.1)
    if fmt == "bin":
        torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    else:
        from safetensors.torch import save_file
        save_file(sd, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg.to_hf_dict(), f)
    write_vocab(d)
    return sd


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_encoders_match_reference(tmp_path, fmt):
    if fmt == "safetensors":
        pytest.importorskip("safetensors")
    cfg = M.CLIPConfig.tiny_test(vocab_size=524, context_length=16)
    write_checkpoint(str(tmp_path), cfg, fmt)
    crops_p, text_p = M.make_encoders(str(tmp_path), max_batch=32,
                                      device="cpu")
    crops_r, text_r = R.make_encoders(str(tmp_path), max_batch=32)
    rng = np.random.default_rng(2)
    crops = rng.random((70, 3, 40, 40)).astype(np.float32)
    at_size = rng.random((5, 32, 32, 3)).astype(np.float32)
    texts = ["the cat", "a dog and the cat", "12!", "IT'S the DOG'S", ""]
    for got, want in ((crops_p(crops), crops_r(crops)),
                      (crops_p(at_size), crops_r(at_size)),
                      (text_p(texts), text_r(texts))):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0,
                                   atol=1e-5)
    assert crops_p(crops[:0]).shape == (0, cfg.projection_dim)
    assert text_p([]).shape == (0, cfg.projection_dim)
    assert crops_p.model is text_p.model


def test_encoders_need_the_card_unless_the_cpu_is_asked_for(tmp_path,
                                                            monkeypatch):
    cfg = M.CLIPConfig.tiny_test(vocab_size=524, context_length=16)
    write_checkpoint(str(tmp_path), cfg, "bin")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_encoders(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        M.load_torch_checkpoint(str(tmp_path / "nothing"), cfg)


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    dt = {"F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16}[dtype]
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(7, 5, generator=g).to(dt),
               "b": torch.randn((), generator=g).to(dt),
               "c.bias": torch.randn(3, generator=g).to(dt),
               "position_ids": torch.arange(6)[None]}
    path = str(tmp_path / "m.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    got = M.read_safetensors(path)
    want = st.load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k], want[k]), k
    if dtype != "BF16":       # numpy has no bf16
        from safetensors.numpy import load_file
        for k, v in load_file(path).items():
            np.testing.assert_array_equal(got[k].numpy(), v)
