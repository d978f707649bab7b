"""Place-recognition descriptors (counterpart of
vggt_slam_tpu/models/retrieval.py): SALAD (serizba/salad `dino_salad`) on
the port's DINOv2-B/14 at 224x224: cluster features and scores from 1x1
stacks, a global token from CLS, log-domain Sinkhorn with a dustbin; the
8448-D descriptor is matched by L2 distance under 0.80
(slam/loop_closure.py). f32; attention on `flash_single` (bf16 q, k, v)
on the card. And the weight-free tiny-image descriptor.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vggt_slam_tpu_torch.data.images import resize_area
from vggt_slam_tpu_torch.models.vggt import convert as C
from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig
from vggt_slam_tpu_torch.models.vggt.modules import Dense
from vggt_slam_tpu_torch.models.vggt.vit import DinoViT


@dataclasses.dataclass(frozen=True)
class SALADConfig:
    input_size: int = 224
    patch_size: int = 14
    backbone_dim: int = 768
    backbone_depth: int = 12
    backbone_heads: int = 12
    num_clusters: int = 64
    cluster_dim: int = 128
    token_dim: int = 256
    hidden_dim: int = 512
    sinkhorn_iters: int = 3
    dtype: torch.dtype = torch.float32
    # "flash": the attention kernels (their plain versions on the CPU);
    # "chunked": plain attention everywhere (the reference's route).
    attn_impl: str = "flash"

    @staticmethod
    def tiny(**overrides) -> "SALADConfig":
        base = dict(input_size=56, backbone_dim=32, backbone_depth=2,
                    backbone_heads=2, num_clusters=8, cluster_dim=16,
                    token_dim=16, hidden_dim=16, sinkhorn_iters=2)
        base.update(overrides)
        return SALADConfig(**base)

    def backbone_vit_config(self) -> VGGTConfig:
        # DINOv2-B/14 as released for SALAD: LayerScale, no register tokens.
        return VGGTConfig(
            img_size=self.input_size, patch_size=self.patch_size,
            enc_dim=self.backbone_dim, enc_depth=self.backbone_depth,
            enc_heads=self.backbone_heads, enc_num_registers=0,
            dtype=self.dtype, attn_impl=self.attn_impl)


def log_otp_solver(log_a, log_b, M, num_iters: int):
    """Log-domain Sinkhorn (SuperGlue style) for (..., m+1, n) costs M with
    row marginals log_a (..., m+1) (last = dustbin) and column marginals
    log_b (..., n). Returns the log transport plan (..., m+1, n)."""
    u = torch.zeros_like(log_a)
    v = torch.zeros_like(log_b)
    for _ in range(num_iters):
        u = log_a - torch.logsumexp(M + v[..., None, :], dim=-1)
        v = log_b - torch.logsumexp(M + u[..., :, None], dim=-2)
    return M + u[..., :, None] + v[..., None, :]


def get_matching_probs(S, dustbin_score, num_iters: int):
    """SALAD's assignment of (..., K, n) scores: a learned dustbin row
    appended, optimal transport where it absorbs the n - K leftover mass (1
    where n <= K), then exp(log_P - log(1/n)) without the dustbin: (..., K,
    n)."""
    K, n = S.shape[-2:]
    dust = torch.as_tensor(dustbin_score, dtype=S.dtype,
                           device=S.device).expand(*S.shape[:-2], 1, n)
    S_aug = torch.cat([S, dust], dim=-2)
    norm = -math.log(n)
    log_a = torch.full((K + 1,), norm, dtype=S.dtype, device=S.device)
    log_a[-1] += math.log(max(n - K, 1))
    log_b = torch.full((n,), norm, dtype=S.dtype, device=S.device)
    log_P = log_otp_solver(log_a, log_b, S_aug, num_iters)
    return torch.exp(log_P - norm)[..., :-1, :]


def _normalize(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class SALAD(nn.Module):
    def __init__(self, cfg: SALADConfig):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.backbone_dim, cfg.hidden_dim
        self.backbone = DinoViT(cfg.backbone_vit_config(), return_cls=True)
        self.cluster_hidden = Dense(d, h, cfg.dtype)
        self.cluster_out = Dense(h, cfg.cluster_dim, cfg.dtype)
        self.score_hidden = Dense(d, h, cfg.dtype)
        self.score_out = Dense(h, cfg.num_clusters, cfg.dtype)
        self.token_hidden = Dense(d, h, cfg.dtype)
        self.token_out = Dense(h, cfg.token_dim, cfg.dtype)
        self.dust_bin = nn.Parameter(torch.empty(()))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, 3, H, W) in [0, 1] -> (B, token_dim + num_clusters *
        cluster_dim) unit-norm descriptors. Frames other than input_size square are resized
        bilinearly, antialiased when shrinking (jax.image.resize)."""
        cfg = self.cfg
        B = images.shape[0]
        s = cfg.input_size
        if tuple(images.shape[-2:]) != (s, s):
            images = F.interpolate(images, size=(s, s), mode="bilinear",
                                   align_corners=False, antialias=True)
        feats, cls = self.backbone(images)     # (B, n, d), (B, d)
        local = self.cluster_out(torch.relu(self.cluster_hidden(feats)))
        scores = self.score_out(torch.relu(self.score_hidden(feats)))
        glob = self.token_out(torch.relu(self.token_hidden(cls)))
        assign = get_matching_probs(scores.transpose(1, 2),
                                    self.dust_bin, cfg.sinkhorn_iters)
        clusters = _normalize(torch.einsum("bkn,bnc->bkc", assign, local))
        # (B, Cd, K) flattened channel-major, as the public SALAD
        clusters = clusters.transpose(1, 2).reshape(
            B, cfg.num_clusters * cfg.cluster_dim)
        return _normalize(torch.cat([_normalize(glob), clusters], dim=-1))


def init_params(cfg: SALADConfig, generator: torch.Generator,
                device) -> dict:
    """Seeded random SALAD weights drawn on `device`, as the VGGT's
    (models/vggt/convert.init_params); the dust bin starts at 1."""
    with torch.device("meta"):
        model = SALAD(cfg)
    return C.init_module_params(model, generator, device)


# Torch checkpoint conversion (dino_salad.ckpt)

_AGG_NAMES = {
    "cluster_hidden": "aggregator.cluster_features.0",
    "cluster_out": "aggregator.cluster_features.2",
    "score_hidden": "aggregator.score.0",
    "score_out": "aggregator.score.2",
    "token_hidden": "aggregator.token_features.0",
    "token_out": "aggregator.token_features.2",
}


def allowed_unused_salad(key: str) -> bool:
    """DINOv2's masked-image-modeling token, never used at inference."""
    return key == "backbone.model.mask_token"


def _salad_name_candidates(flax_path: str) -> list[str]:
    """A flax SALAD param path -> candidate torch state-dict names."""
    p = flax_path
    if p == "params/dust_bin":
        return ["aggregator.dust_bin"]
    for ours, theirs in _AGG_NAMES.items():
        if f"/{ours}/" in p:
            leaf = p.rsplit("/", 1)[1].replace("kernel", "weight")
            return [f"{theirs}.{leaf}"]
    # the salad repo wraps torch.hub's DINOv2 as backbone.model
    p = p.replace("params/backbone/", "")
    p = p.replace("block_", "blocks.")
    p = p.replace("patch_embed/kernel", "patch_embed.proj.weight")
    p = p.replace("patch_embed/bias", "patch_embed.proj.bias")
    p = p.replace("/kernel", ".weight").replace("/bias", ".bias")
    p = p.replace("/scale", ".weight")
    p = p.replace("/", ".")
    return [f"backbone.model.{p}", f"backbone.{p}", p]


def _salad_kernel_layout(arr: np.ndarray, cand: str, shape) -> np.ndarray:
    """1x1 conv -> dense, conv OIHW -> HWIO, linear (out, in) -> (in, out)."""
    if not cand.endswith(".weight"):
        return arr
    if arr.ndim == 4 and arr.shape[2:] == (1, 1) and len(shape) == 2:
        return arr[:, :, 0, 0].T
    if arr.ndim == 4 and len(shape) == 4:
        return arr.transpose(2, 3, 1, 0)
    if arr.ndim == 2 and len(shape) == 2:
        return arr.T
    return arr


def convert_torch_state_dict(state_dict: dict, template: dict):
    """The public dino_salad state dict -> the port's SALAD state dict and
    a match report (reference retrieval.py:201). `template`: the port's
    SALAD parameters, e.g. `C.meta_template(SALAD, cfg)`."""
    flat_t = {k: C._to_numpy(v) for k, v in state_dict.items()}
    C._structural_transforms(flat_t)
    return C.fill_state_dict(flat_t, template, _salad_name_candidates,
                             _salad_kernel_layout)


def convert_torch_checkpoint(torch_path: str, out_path: str,
                             cfg: SALADConfig | None = None):
    """dino_salad.ckpt (optionally under "state_dict") -> the port's flat
    npz, with the match report (reference retrieval.py:243)."""
    sd, report = convert_torch_state_dict(
        C.load_torch_state_dict(torch_path, "state_dict"),
        C.meta_template(SALAD, cfg or SALADConfig()))
    C.report_conversion("salad-convert", report)
    C.save_checkpoint(sd, out_path)
    return report


# Descriptor callables for slam/loop_closure.ImageRetrieval

@functools.lru_cache(maxsize=4)
def build_salad(input_size: int = 224, checkpoint: str | None = None,
                device: str = "cuda") -> SALAD:
    """SALAD at `input_size` with a converted checkpoint's weights, or
    random ones from seed 7 (the reference's key), on `device`; built once
    per argument set."""
    from vggt_slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = SALADConfig(input_size=input_size)
    if checkpoint:
        sd = C.load_checkpoint(checkpoint, dev)
    else:
        sd = init_params(cfg, torch.Generator(device=dev).manual_seed(7),
                         dev)
    with torch.device("meta"):
        model = SALAD(cfg)
    model.load_state_dict(sd, assign=True)
    return model.eval()


def default_descriptor_fn(input_size: int = 224,
                          checkpoint: str | None = None, device="cuda"):
    """SALAD descriptor callable, (S, 3, H, W) [0, 1] -> (S, D) numpy, built on
    the first call. Random weights carry no place information, so `run.trusted`
    is True only with a checkpoint (ImageRetrieval disables loops
    otherwise)."""
    def run(frames):
        model = build_salad(input_size, checkpoint, str(device))
        dev = next(model.parameters()).device
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(frames, np.float32), device=dev)
            return model(x).float().cpu().numpy()

    run.trusted = checkpoint is not None
    return run


def tiny_image_descriptor_fn(grid: int = 16):
    """Weight-free place descriptor: the gray grid x grid thumbnail (area
    resize), mean-centred and L2-normalized, so L2 distance is monotone in NCC;
    runs loop closure without weights (--retrieval_backend tiny)."""
    def run(frames):
        frames = np.asarray(frames, np.float32)   # (S, 3, H, W) in [0, 1]
        out = np.empty((frames.shape[0], grid * grid), np.float32)
        for i, f in enumerate(frames):
            g = f.mean(axis=0)
            t = resize_area(g[..., None], grid, grid)[..., 0].ravel()
            t -= t.mean()
            out[i] = t / (np.linalg.norm(t) + 1e-8)
        return out

    run.trusted = True
    return run
