"""Weights for the port's VGGT (counterpart of
vggt_slam_tpu/models/vggt/convert.py): flat flax checkpoints (flax path
"params/a/b/kernel" is state-dict key "a.b.kernel", with the flax
conventions: single-swap rope with the quarter permutation in q/k, tanh
GELU, (k, k, in, out) ConvTranspose kernels), seeded initialisation, and
`convert_torch_state_dict`, which maps the released facebook/VGGT-1B
state dict by the reference's rules, so a `model.pt` becomes the port's
npz without JAX.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from vggt_slam_tpu_torch.models.vggt.modules import lecun_std


def flax_key_to_torch(path: str) -> str:
    if path.startswith("params/"):
        path = path[len("params/"):]
    return path.replace("/", ".")


def torch_key_to_flax(name: str) -> str:
    """The inverse of `flax_key_to_torch`."""
    return "params/" + name.replace(".", "/")


def save_checkpoint(state_dict: dict, path: str) -> None:
    """A state dict -> the reference's flat npz (keys = flax paths, f32),
    which `load_checkpoint` here and in the reference both read."""
    np.savez(path, **{torch_key_to_flax(k): v.detach().float().cpu().numpy()
                      for k, v in state_dict.items()})


def load_flax_params(flat: dict, device="cpu") -> dict:
    """{flax path: array} -> state dict of f32 tensors on `device`."""
    return {flax_key_to_torch(k): torch.as_tensor(
        np.array(v, dtype=np.float32), device=device)
        for k, v in flat.items()}


def load_checkpoint(npz_path: str, device="cpu") -> dict:
    """A reference flat npz checkpoint (keys = flax paths) -> state dict."""
    with np.load(npz_path) as data:
        return load_flax_params({k: data[k] for k in data.files}, device)


def _init_value(name: str, shape, generator, device, model_owner):
    """One parameter drawn as the reference's flax initialisers draw it."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel":
        std = lecun_std(shape)
        return torch.randn(shape, generator=generator, device=device) * std
    if leaf in ("pos_embed", "cls_token", "register_tokens", "camera_token",
                "register_token"):
        return torch.randn(shape, generator=generator, device=device) * 0.02
    if leaf == "gamma":
        return torch.full(shape, model_owner.init_value, device=device)
    if leaf in ("scale", "dust_bin"):
        return torch.ones(shape, device=device)
    if leaf in ("bias", "empty_pose_tokens"):
        return torch.zeros(shape, device=device)
    raise KeyError(f"no initialiser for parameter {name}")


def init_module_params(model, generator: torch.Generator, device) -> dict:
    """Seeded weights for `model` (built on the meta device), drawn on
    `device`: lecun-normal kernels, N(0, 0.02) tokens and position embeddings,
    LayerScale at its init, unit LayerNorm scales and SALAD dust bin, zero
    biases. Returns the state dict."""
    owners = dict(model.named_modules())
    sd = {}
    for name, p in model.named_parameters():
        owner = owners[name.rsplit(".", 1)[0]] if "." in name else model
        sd[name] = _init_value(name, tuple(p.shape), generator, device, owner)
    return sd


def init_params(cfg, generator: torch.Generator, device) -> dict:
    """Seeded random weights for VGGT(cfg), drawn directly on `device` (the
    1B model's 4.8 GB never cross the host). Returns the state dict."""
    from vggt_slam_tpu_torch.models.vggt.model import VGGT

    with torch.device("meta"):
        model = VGGT(cfg)
    return init_module_params(model, generator, device)


# Torch -> flax mapping (reference convert.py:76-297)

def allowed_unused_vggt(key: str) -> bool:
    """Checkpoint keys the converter drops: DINOv2's mask_token, the
    aggregator's normalization buffers (folded into preprocessing), DPT's
    never-called refinenet4.resConfUnit1, the tracking head."""
    return (key == "aggregator.patch_embed.mask_token"
            or key.startswith("aggregator._resnet_")
            or ".scratch.refinenet4.resConfUnit1." in key
            or key.startswith("track_head."))


def _torch_name_candidates(flax_path: str) -> list[str]:
    """One flax param path -> the public facebookresearch/vggt state-dict
    name: leaf suffixes renamed first (kernel/scale -> weight), then the
    digit-anchored module renames, on a dot-separated path."""
    p = flax_path
    if p.startswith("params/"):
        p = p[len("params/"):]
    p = p.replace("/", ".")
    p = re.sub(r"\.kernel$", ".weight", p)
    p = re.sub(r"\.scale$", ".weight", p)
    p = re.sub(r"\bframe_block_(\d+)", r"frame_blocks.\1", p)
    p = re.sub(r"\bglobal_block_(\d+)", r"global_blocks.\1", p)
    p = re.sub(r"\bblock_(\d+)", r"blocks.\1", p)      # DINOv2 encoder
    p = re.sub(r"\btrunk_(\d+)", r"trunk.\1", p)       # camera-head trunk
    p = p.replace(".modulation.", ".poseLN_modulation.1.")
    p = re.sub(r"\bprojects_(\d+)", r"projects.\1", p)
    p = re.sub(r"\bresize_(\d+)", r"resize_layers.\1", p)
    p = re.sub(r"\blayer_rn_(\d+)",
               lambda m: f"scratch.layer{int(m.group(1)) + 1}_rn", p)
    p = re.sub(r"\brefinenet(\d+)", r"scratch.refinenet\1", p)
    p = p.replace(".output_conv1.", ".scratch.output_conv1.")
    p = p.replace(".output_conv2_0.", ".scratch.output_conv2.0.")
    p = p.replace(".output_conv2_2.", ".scratch.output_conv2.2.")
    p = p.replace("patch_embed.patch_embed.", "patch_embed.patch_embed.proj.")
    return [p]


def _structural_transforms(flat_t: dict) -> None:
    """Reshape in place the torch arrays whose layout differs (camera_token,
    register_token lose the leading 1; DINOv2's pos_embed splits into
    cls_token's slot and a (1, g, g, C) grid), then
    `_rope_pairing_transforms`."""
    for key in ("aggregator.camera_token", "aggregator.register_token"):
        arr = flat_t.get(key)
        if arr is not None and arr.ndim == 4 and arr.shape[0] == 1 \
                and arr.shape[1] == 2:
            flat_t[key] = arr[0]

    for key in list(flat_t):
        if not key.endswith("pos_embed"):
            continue
        arr = flat_t[key]
        if arr.ndim != 3 or arr.shape[0] != 1:
            continue
        n, C = arr.shape[1] - 1, arr.shape[2]
        g = int(round(n ** 0.5))
        if g * g != n:
            continue
        cls_key = key[: -len("pos_embed")] + "cls_token"
        if cls_key in flat_t:
            flat_t[cls_key] = flat_t[cls_key] + arr[:, :1]
        flat_t[key] = arr[:, 1:].reshape(1, g, g, C)
    _rope_pairing_transforms(flat_t)


def _quarter_perm(n: int) -> np.ndarray:
    q = n // 4
    idx = np.arange(n)
    return np.concatenate([idx[:q], idx[2 * q:3 * q], idx[q:2 * q],
                           idx[3 * q:]])


def _rope_pairing_transforms(flat_t: dict) -> None:
    """Permute the frame and global blocks' q/k head dims by [q0, q2, q1,
    q3] in place: croco's rope pairs i with i + Dh/4 in each half, the port's
    kernels (i, i + Dh/2) with the table [y | x]; scores agree once q, k and
    their norms are permuted alike."""
    pat = re.compile(r"(frame|global)_blocks\.\d+\.attn\.")
    for key in list(flat_t):
        m = pat.search(key)
        if m is None:
            continue
        arr = flat_t[key]
        tail = key[m.end():]
        if tail in ("q_norm.weight", "q_norm.bias",
                    "k_norm.weight", "k_norm.bias"):
            flat_t[key] = arr[_quarter_perm(arr.shape[0])]
        elif tail in ("qkv.weight", "qkv.bias"):
            # qkv rows: q, k, v; the head dim is the block's q_norm length
            norm_key = key[: m.end()] + "q_norm.weight"
            if norm_key not in flat_t:
                continue
            dh = flat_t[norm_key].shape[0]
            C = arr.shape[0] // 3
            rows = np.arange(arr.shape[0])
            qk = rows[: 2 * C].reshape(2, C // dh, dh)[
                ..., _quarter_perm(dh)].reshape(-1)
            flat_t[key] = arr[np.concatenate([qk, rows[2 * C:]])]


def _to_numpy(v) -> np.ndarray:
    """A torch tensor or array -> numpy; bf16 (the released VGGT-1B's
    dtype, which .numpy() refuses) upcast to f32, exactly."""
    if hasattr(v, "detach"):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _torch_kernel_layout(arr: np.ndarray, cand: str, shape) -> np.ndarray:
    """A torch `.weight` in the port's layout: ConvTranspose (in, out, k, k)
    -> (k, k, in, out), conv OIHW -> HWIO, linear (out, in) -> (in, out)."""
    if not cand.endswith(".weight"):
        return arr
    if arr.ndim == 4 and (".resize_layers.0." in cand
                          or ".resize_layers.1." in cand):
        return arr.transpose(2, 3, 0, 1)
    if arr.ndim == 4 and len(shape) == 4:
        return arr.transpose(2, 3, 1, 0)
    if arr.ndim == 2 and len(shape) == 2:
        return arr.T
    return arr


def fill_state_dict(flat_t: dict, template: dict, candidates, layout):
    """Fill `template`'s parameters (shapes only) from the first candidate
    torch name whose array, after `layout`, fits; unmatched ones are zeros.
    Returns (f32 CPU state dict, report of unmatched paths and unused keys)."""
    used, unmatched, out = set(), [], {}
    for name, p in template.items():
        shape = tuple(p.shape)
        path = torch_key_to_flax(name)
        for cand in candidates(path):
            if cand not in flat_t:
                continue
            arr = layout(flat_t[cand], cand, shape)
            if arr.shape == shape:
                used.add(cand)
                out[name] = torch.from_numpy(
                    np.asarray(arr, np.float32).reshape(shape))
                break
        else:
            unmatched.append(path)
            out[name] = torch.zeros(shape)
    return out, {"unmatched_flax": unmatched,
                 "unused_torch": sorted(set(flat_t) - used)}


def meta_template(module_cls, cfg) -> dict:
    """{name: meta parameter} of module_cls(cfg): shapes, no memory."""
    with torch.device("meta"):
        return dict(module_cls(cfg).named_parameters())


def convert_torch_state_dict(state_dict: dict, template: dict):
    """The released VGGT state dict -> the port's state dict and a match
    report (reference convert.py:218). `template`: the port's VGGT
    parameters, e.g. `meta_template(VGGT, cfg)`."""
    flat_t = {k: _to_numpy(v) for k, v in state_dict.items()}
    _structural_transforms(flat_t)
    return fill_state_dict(flat_t, template, _torch_name_candidates,
                           _torch_kernel_layout)


def load_torch_state_dict(torch_path: str, wrapper: str) -> dict:
    """torch.load of a checkpoint on the CPU, unwrapped from `wrapper`."""
    sd = torch.load(torch_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get(wrapper), dict):
        sd = sd[wrapper]
    return sd


def report_conversion(tag: str, report: dict) -> None:
    print(f"[{tag}] unmatched flax params: {len(report['unmatched_flax'])}; "
          f"unused torch keys: {len(report['unused_torch'])}")
    for p in report["unmatched_flax"][:20]:
        print("  missing:", p)


def convert_torch_checkpoint(torch_path: str, out_path: str, cfg=None):
    """model.pt (optionally under a "model" key) -> the port's flat npz,
    with the match report (reference convert.py:278)."""
    from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig
    from vggt_slam_tpu_torch.models.vggt.model import VGGT

    sd, report = convert_torch_state_dict(
        load_torch_state_dict(torch_path, "model"),
        meta_template(VGGT, cfg or VGGTConfig.vggt_1b()))
    report_conversion("convert", report)
    save_checkpoint(sd, out_path)
    return report
