"""Train a small VGGT on synthetic 3D scenes on one device (counterpart of
vggt_slam_tpu/tools/train_tiny.py).

Trains `VGGTConfig.small` on tools/synth3d.py's heightfield scenes with
parallel/train.vggt_loss (pose-encoding regression plus confidence-weighted
depth, a pose weight, an optional scale-consistency term), exact attention
through `flash_grad` (the forward kernels with row stats and `flash_bwd`)
and activation checkpointing; on the card the last output line holds the
launches by design. The optimizer is the reference's optax chain
(clip_by_global_norm, AdamW under a linear-warmup cosine schedule whose
first update has lr 0); parameters and optimizer state are saved in the
reference's flat npz layouts, so either package resumes the other's run.

  python -m vggt_slam_tpu_torch.tools.train_tiny --out runs/small_synth \
      [--steps 8000] [--frames 10] [--model_size small] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import queue
import threading
import time

import numpy as np
import torch

SIZES = ("small", "small64", "small256", "tiny")


def build_cfg(model_size: str, on_card: bool, attn_impl: str | None = None):
    """Training configuration: flash_grad attention (chunked on request),
    no point head, exact global attention, activation checkpointing; bf16
    on the card, f32 on the CPU."""
    from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig

    kw = dict(attn_impl=attn_impl or "flash_grad", enable_point_head=False,
              global_kv_stride=1,
              dtype=torch.bfloat16 if on_card else torch.float32,
              remat=True)
    if model_size == "small":
        return VGGTConfig.small(**kw)
    if model_size == "small64":
        return VGGTConfig.small64(**kw)
    if model_size == "small256":
        return VGGTConfig.small256(**kw)
    return VGGTConfig.tiny(img_size=518, **kw)


def warmup_cosine(count: int, peak: float, warmup: int, decay_steps: int,
                  end: float) -> float:
    """optax.warmup_cosine_decay_schedule(0.0, peak, warmup, decay_steps,
    end) at update `count` (0 for the first update)."""
    if count < warmup:
        frac = 1.0 - min(max(count, 0), warmup) / warmup
        return -peak * frac + peak
    t = min(count - warmup, decay_steps - warmup)
    alpha = 0.0 if peak == 0.0 else end / peak
    cosine = 0.5 * (1 + math.cos(math.pi * t / (decay_steps - warmup)))
    return peak * ((1 - alpha) * cosine + alpha)


def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the .grad of `params`, in place: scale
    every gradient by max_norm / norm when the global norm reaches max_norm
    (torch's clip_grad_norm_ adds 1e-6 to the norm; this does not)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def make_optimizer(model, lr: float, weight_decay: float, warmup: int,
                   steps: int):
    """-> (AdamW, LambdaLR) matching the reference's
    chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule(...)))
    (the clipping is `clip_by_global_norm`, called before each step)."""
    opt = torch.optim.AdamW(model.parameters(), lr=lr,
                            weight_decay=weight_decay)
    decay = max(steps, warmup + 1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda c: warmup_cosine(c, lr, warmup, decay, lr * 1e-2) / lr)
    return opt, sched


def _flax_order(model) -> list:
    """The model's parameters in the order jax.tree_util.tree_leaves walks
    the reference's flax parameter tree: nested dicts, keys sorted."""
    from vggt_slam_tpu_torch.models.vggt.convert import torch_key_to_flax
    named = sorted(model.named_parameters(),
                   key=lambda kv: tuple(torch_key_to_flax(kv[0]).split("/")))
    return [p for _, p in named]


def save_train_state(opt, sched, model, step: int, path: str) -> None:
    """Optimizer state and step in the reference's `<stem>_opt.npz` layout
    (train_tiny.py:63-79): `step`, then chain(clip_by_global_norm, adamw)'s
    leaves: the Adam count, mu and nu over the sorted flax paths, the
    schedule's count."""
    params = _flax_order(model)
    mu, nu, count = [], [], 0
    for p in params:
        st = opt.state.get(p) or {}
        if st:
            count = int(st["step"])
        for out, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            t = st.get(key)
            out.append(np.zeros(tuple(p.shape), np.float32) if t is None
                       else t.detach().float().cpu().numpy())
    leaves = [np.int32(count), *mu, *nu, np.int32(sched.last_epoch)]
    np.savez(path, step=np.int64(step),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})


def load_train_state(opt, sched, model, path: str) -> int:
    """Restore `opt` from either package's `<stem>_opt.npz`, `sched` at the
    saved count (with this run's learning rate there); returns the step."""
    params = _flax_order(model)
    n = len(params)
    with np.load(path) as data:
        n_leaves = sum(k.startswith("leaf_") for k in data.files)
        if n_leaves != 2 * n + 2:
            raise ValueError(f"{path}: {n_leaves} optimizer leaves, the "
                             f"model needs {2 * n + 2}")
        count = int(data["leaf_0"])
        for i, p in enumerate(params):
            mu, nu = data[f"leaf_{1 + i}"], data[f"leaf_{1 + n + i}"]
            if mu.shape != tuple(p.shape) or nu.shape != tuple(p.shape):
                raise ValueError(f"{path}: leaf {1 + i} has shape "
                                 f"{mu.shape}, the parameter {tuple(p.shape)}")
            opt.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": torch.as_tensor(mu, device=p.device,
                                           dtype=p.dtype).clone(),
                "exp_avg_sq": torch.as_tensor(nu, device=p.device,
                                              dtype=p.dtype).clone()}
        sched_count = int(data[f"leaf_{2 * n + 1}"])
        step = int(data["step"])
    sched.last_epoch = sched_count
    for group, lam in zip(opt.param_groups, sched.lr_lambdas):
        group["lr"] = group["initial_lr"] * lam(sched_count)
    return step


def make_loss_fn(cfg, pose_weight: float, conf_alpha: float,
                 scale_weight: float = 0.0):
    """-> loss_fn(model, batch) -> (loss, aux dict of 0-d tensors)."""

    def loss_fn(model, batch):
        out = model(batch["images"])
        pose_err = (out["pose_enc"] - batch["pose_enc_gt"]) ** 2
        pose_loss = torch.mean(pose_err)
        err = torch.abs(out["depth"][..., 0] - batch["depth_gt"])
        conf = out["depth_conf"]
        depth_loss = torch.mean(conf * err - conf_alpha * torch.log(conf))
        aux = {"pose_mse": pose_loss, "depth_l1": torch.mean(err),
               "trans_rmse": torch.sqrt(torch.mean(pose_err[:, :3]))}
        loss = pose_weight * pose_loss + depth_loss
        if scale_weight > 0.0:
            # Metric-scale consistency in log space, on the scene's mean
            # depth and mean camera-translation magnitude (frame 0 is the
            # identity anchor).
            d_ratio = (torch.mean(out["depth"][..., 0])
                       / (torch.mean(batch["depth_gt"]) + 1e-6))
            t_pred = torch.linalg.norm(out["pose_enc"][1:, :3], dim=-1)
            t_gt = torch.linalg.norm(batch["pose_enc_gt"][1:, :3], dim=-1)
            t_ratio = (torch.mean(t_pred) + 1e-6) / (torch.mean(t_gt) + 1e-6)
            scale_loss = (torch.log(torch.clamp(d_ratio, min=1e-6)) ** 2
                          + torch.log(torch.clamp(t_ratio, min=1e-6)) ** 2)
            aux["scale_loss"] = scale_loss
            aux["depth_scale"] = d_ratio
            loss = loss + scale_weight * scale_loss
        return loss, aux

    return loss_fn


parser = argparse.ArgumentParser(description="Train small VGGT on synth3d")
parser.add_argument("--out", required=True,
                    help="output dir (checkpoint.npz + train_log.jsonl)")
parser.add_argument("--steps", type=int, default=8000)
parser.add_argument("--frames", type=int, default=10,
                    help="frames per scene batch (match the eval submap "
                         "bucket: submap_size + overlap + max_loops)")
parser.add_argument("--image_hw", type=int, nargs=2, default=(392, 518))
parser.add_argument("--model_size", default="small", choices=SIZES)
parser.add_argument("--lr", type=float, default=3e-4)
parser.add_argument("--warmup", type=int, default=200)
parser.add_argument("--weight_decay", type=float, default=0.01)
parser.add_argument("--clip", type=float, default=1.0)
parser.add_argument("--pose_weight", type=float, default=5.0)
parser.add_argument("--conf_alpha", type=float, default=0.2)
parser.add_argument("--scale_weight", type=float, default=0.0,
                    help="metric-scale consistency weight (log-space depth "
                         "+ translation scale-ratio penalty; 0 = off)")
parser.add_argument("--ckpt_every", type=int, default=500)
parser.add_argument("--val_every", type=int, default=250)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--resume", default=None,
                    help="checkpoint.npz to warm-start params from; if a "
                         "sibling <stem>_opt.npz exists (written by either "
                         "package), optimizer state and step index are "
                         "restored too")
parser.add_argument("--attn_impl", default="flash_grad",
                    choices=["flash_grad", "chunked"],
                    help="attention implementation (default: the flash "
                         "kernels; chunked is the plain reference path)")
parser.add_argument("--device", default="cuda",
                    help="device to train on (default: the card; cpu runs "
                         "the kernels' plain versions)")


def _opt_path(ckpt_path: str) -> str:
    stem = ckpt_path[:-4] if ckpt_path.endswith(".npz") else ckpt_path
    return stem + "_opt.npz"


def main(argv=None):
    args = parser.parse_args(argv)

    from vggt_slam_tpu_torch.main import build_model
    from vggt_slam_tpu_torch.models.vggt.convert import save_checkpoint
    from vggt_slam_tpu_torch.tools import synth3d
    from vggt_slam_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = build_cfg(args.model_size, device.type == "cuda", args.attn_impl)
    H, W = args.image_hw
    os.makedirs(args.out, exist_ok=True)

    t0 = time.time()
    model = build_model(cfg, args.resume, args.seed, device).train()
    if args.resume:
        print(f"resumed params from {args.resume}", flush=True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"device={device} model={args.model_size} "
          f"params={n_params/1e6:.2f}M init={time.time()-t0:.1f}s",
          flush=True)

    warmup = min(args.warmup, max(args.steps // 4, 1))
    opt, sched = make_optimizer(model, args.lr, args.weight_decay, warmup,
                                args.steps)
    start_step = 1
    if args.resume and os.path.exists(_opt_path(args.resume)):
        last_step = load_train_state(opt, sched, model,
                                     _opt_path(args.resume))
        start_step = last_step + 1
        print(f"resumed opt state + step {last_step} from "
              f"{_opt_path(args.resume)}", flush=True)

    loss_fn = make_loss_fn(cfg, args.pose_weight, args.conf_alpha,
                           args.scale_weight)
    params = list(model.parameters())

    def train_step(batch):
        opt.zero_grad(set_to_none=True)
        loss, aux = loss_fn(model, batch)
        loss.backward()
        clip_by_global_norm(params, args.clip)
        opt.step()
        sched.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    @torch.no_grad()
    def eval_loss(batch):
        return loss_fn(model, batch)

    def get_batch(seed):
        b = synth3d.training_batch(seed, n_frames=args.frames,
                                   image_hw=(H, W))
        return {k: torch.from_numpy(v) for k, v in b.items()}

    def to_device(batch):
        return {k: v.to(device, non_blocking=True) for k, v in batch.items()}

    # Fixed validation scenes (seeds disjoint from the training stream and
    # from the eval sequences, which use small seeds).
    val_batches = [to_device(get_batch(1_000_000 + i)) for i in range(3)]

    # Scene rendering runs on a worker thread ahead of the device step; the
    # queue bounds host memory.
    batch_q: queue.Queue = queue.Queue(maxsize=3)

    def producer():
        for step in range(start_step, args.steps + 1):
            batch_q.put(get_batch(args.seed * 10_000_000 + step))

    threading.Thread(target=producer, daemon=True).start()

    log_path = os.path.join(args.out, "train_log.jsonl")
    ckpt_path = os.path.join(args.out, "checkpoint.npz")
    meta_path = os.path.join(args.out, "checkpoint_meta.json")
    last_path = os.path.join(args.out, "last.npz")
    # Carry best_val across resumes, so a fresh attempt's first validation
    # cannot overwrite a better checkpoint.
    best_val = float("inf")
    if args.resume and os.path.exists(meta_path):
        with open(meta_path) as f:
            best_val = float(json.load(f).get("best_val", float("inf")))
        print(f"resumed best_val={best_val:.4f}", flush=True)
    t_start = time.time()

    def log_train_row(ps, ploss, paux):
        # The loss is read back one step late, after the next step is
        # queued, so the host does not wait for the device every step.
        if ps % 25 == 0 or ps == 1:
            row = {"step": ps, "loss": float(ploss),
                   **{k: float(v) for k, v in paux.items()},
                   "wall_s": round(time.time() - t_start, 1)}
            with open(log_path, "a") as f:
                f.write(json.dumps(row) + "\n")
            print(row, flush=True)

    pending = None
    for step in range(start_step, args.steps + 1):
        batch = to_device(batch_q.get())
        loss, aux = train_step(batch)
        if pending is not None:
            log_train_row(*pending)
        pending = (step, loss, aux)

        if step % args.val_every == 0 or step == args.steps:
            vals = [eval_loss(vb) for vb in val_batches]
            vloss = float(np.mean([float(v[0]) for v in vals]))
            vtrans = float(np.mean([float(v[1]["trans_rmse"]) for v in vals]))
            vdepth = float(np.mean([float(v[1]["depth_l1"]) for v in vals]))
            row = {"step": step, "val_loss": vloss, "val_trans_rmse": vtrans,
                   "val_depth_l1": vdepth,
                   "wall_s": round(time.time() - t_start, 1)}
            with open(log_path, "a") as f:
                f.write(json.dumps(row) + "\n")
            print(row, flush=True)
            if vloss < best_val:
                best_val = vloss
                save_checkpoint(model.state_dict(), ckpt_path)
                with open(meta_path, "w") as f:
                    json.dump({"best_val": best_val, "step": step}, f)
                print(f"saved {ckpt_path} (val_loss {vloss:.4f})", flush=True)

        if step % args.ckpt_every == 0:
            save_checkpoint(model.state_dict(), last_path)
            save_train_state(opt, sched, model, step, _opt_path(last_path))

    if pending is not None:
        log_train_row(*pending)
    save_checkpoint(model.state_dict(), last_path)
    save_train_state(opt, sched, model, args.steps, _opt_path(last_path))
    print(f"done: best val_loss {best_val:.4f}; checkpoint at {ckpt_path}",
          flush=True)
    if device.type == "cuda":   # which kernels, and which backward design
        from vggt_slam_tpu_torch.ops import attention as A
        print(json.dumps({"kernel_launches": dict(A.LAUNCHES),
                          "bwd_design_launches": A.bwd_design_launches()}),
              flush=True)


if __name__ == "__main__":
    main()
