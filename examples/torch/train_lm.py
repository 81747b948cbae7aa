"""End-to-end driver on the PyTorch port: train the FULL xlstm-125m config
(~125M params) on the synthetic LM stream, with checkpointing and
straggler detection, through ``repro_torch.launch.train``.

The counterpart of ``examples/train_lm.py``: the same arguments handed
to the launcher, plus ``--device``. It trains on the card unless
``--device cpu`` asks for the host; without a card it exits 2. As in the
JAX package's run at this width, the gradient norm explodes from the
first step on random weights (NaN at the default 4 x 256 tokens; the
sLSTM layers amplify their input), so the loss is not expected to fall.

Run:  PYTHONPATH=src python examples/torch/train_lm.py [--steps 300] \\
          [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: cuda; the host "
                         "only when asked with --device cpu)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("train_lm: no CUDA device; pass --device cpu to train on "
              "the host", file=sys.stderr)
        return 2
    # the reference's argv, then --device
    train_main(["--arch", "xlstm-125m",            # full 125M config
                "--steps", str(args.steps),
                "--batch", str(args.batch),
                "--seq", str(args.seq),
                "--lr", "1e-3",
                "--ckpt-dir", args.ckpt_dir,
                "--ckpt-every", "100",
                "--log-every", "10",
                "--device", args.device])
    return 0


if __name__ == "__main__":
    sys.exit(main())
