"""End-to-end training launcher (counterpart of ``repro/launch/train.py``).

Runs any registered architecture (full or smoke config) on one device,
with checkpoint/restart, straggler detection and optional int8
error-feedback gradient compression. The device is the CUDA card unless
``--device cpu`` asks for the host; without a card it exits 2.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --smoke --steps 20 --batch 8 --seq 128 --ckpt-dir ckpt [--device cpu]

As in the reference, a run resumed from ``--ckpt-dir`` restores the
state at the newest committed step but starts the data stream again at
data step 0 (ROADMAP, "Kept on purpose").
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import make_iterator
from repro_torch.launch.faults import StragglerDetector
from repro_torch.optim.adamw import OptConfig, adamw_update
from repro_torch.optim.compression import compress_tree, init_residual
from repro_torch.train import step as step_lib


def build(cfg, shape, oc, accum, compress):
    """The step function: ``make_train_step``, or with ``compress`` one
    gradient pass whose gradients go through ``compress_tree`` (the
    residual carried in ``state["resid"]``) before AdamW."""
    base_step = step_lib.make_train_step(cfg, oc, accum)
    if not compress:
        return base_step

    grad_fn = step_lib.value_and_grad(step_lib.make_loss_fn(cfg))

    def step(state, batch):
        (loss, parts), grads = grad_fn(state["params"], batch)
        grads, resid = compress_tree(grads, state["resid"])
        new_p, new_opt, om = adamw_update(oc, state["params"], grads,
                                          state["opt"], state["step"])
        return ({"params": new_p, "opt": new_opt, "resid": resid,
                 "step": state["step"] + 1},
                {"loss": loss, **parts, **om})
    return step


def main(argv=None):
    """Train; returns the losses of the steps run (a list of floats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: cuda; the host "
                         "only when asked with --device cpu)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("repro_torch.launch.train: no CUDA device; pass --device cpu "
              "to train on the host", file=sys.stderr)
        sys.exit(2)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    oc = OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                   total_steps=args.steps)
    step_fn = build(cfg, shape, oc, args.accum, args.compress)

    state = step_lib.init_train_state(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    if args.compress:
        state["resid"] = init_residual(state["params"])

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt is not None:
        got_step, got_state = ckpt.restore_latest(state)
        if got_step is not None:
            start, state = got_step, got_state
            print(f"[restore] resumed from step {start}")

    it = make_iterator(cfg, shape, seed=args.seed, device=device)
    detector = StragglerDetector()
    losses = []
    for i in range(start, args.steps):
        batch = next(it)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])       # waits for the step
        dt = time.time() - t0
        losses.append(loss)
        if detector.observe(dt):
            print(f"[straggler] step {i} took {dt*1e3:.0f} ms")
        if i % args.log_every == 0:
            print(f"step {i:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt*1e3:.0f} ms)", flush=True)
        if ckpt is not None and (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, state)
    if ckpt is not None:
        ckpt.save(args.steps, state, block=True)
    if losses:
        print(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    else:
        print(f"done: resumed at step {start} >= {args.steps}; nothing to do")
    return losses


if __name__ == "__main__":
    main()
