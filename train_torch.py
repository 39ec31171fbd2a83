#!/usr/bin/env python3
"""Train the PyTorch port of Tacotron 2 on one CUDA card, or data-parallel
on N cards.

The flags are ``train.py``'s, with the same meanings but one, plus
``--device``:

    python train_torch.py processed/metadata.csv checkpoints/run1 \\
        --epochs 100 --batch_size 16 --lr 1e-3 [--debug] \\
        [--val_metadata V.csv] [--resume CKPT] [--postnet_freeze_steps N] \\
        [--accum_steps N] [--precision bf16|fp32] [--keep_epoch_ckpts N] \\
        [--tp 1] [--device cuda|cpu]

On N cards, the same flags under torchrun, one rank a card (NCCL); each
rank loads ``--batch_size`` rows of every global batch of
``batch_size * N``, and each step is the one a single process takes on
the global batch:

    torchrun --nproc_per_node N train_torch.py processed/metadata.csv \\
        checkpoints/run1 --batch_size 16 ...

More ranks than cards share the cards over gloo (two ranks on one card
check the path; they are no faster than one process).  Rank 0 writes the
log and the checkpoints.

``--resume`` takes a checkpoint directory of the port, an Orbax checkpoint
directory of the JAX package or the reference's PyTorch checkpoint file.
It differs from ``train.py``'s in one point: resumed from
``tacotron2_epoch_N`` (or a ``best_model`` saved after epoch N), the port
goes on at epoch N + 1, where ``train.py`` runs epoch N again; so
``--epochs E`` from there trains E - N epochs here and E - N + 1 there.
``--remat`` is not ported (an XLA policy), and ``--tp`` takes 1 only
(tensor parallelism is not ported).
"""

import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="Path to the processed metadata CSV.")
    parser.add_argument("checkpoint_dir", type=str,
                        help="Directory to save checkpoints.")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--debug", action="store_true",
                        help="Debug mode: overfit on a single batch.")
    parser.add_argument("--val_metadata", type=str, default=None)
    parser.add_argument("--resume", type=str, default=None,
                        help="Checkpoint to resume from.  From the epoch N "
                             "checkpoint the port goes on at epoch N + 1 "
                             "(train.py runs epoch N again).")
    parser.add_argument("--postnet_freeze_steps", type=int, default=None)
    parser.add_argument("--accum_steps", type=int, default=1)
    parser.add_argument("--precision", type=str, default=None,
                        choices=["bf16", "bfloat16", "fp32", "float32"],
                        help="Training compute precision (default: the "
                             "config's bfloat16 policy: fp32 master "
                             "weights, bf16 products).")
    parser.add_argument("--keep_epoch_ckpts", type=int, default=None,
                        help="Keep only the newest N per-epoch checkpoints "
                             "(default 5; 0 keeps all).")
    parser.add_argument("--tp", type=int, default=1,
                        help="Tensor-parallel width; the port takes 1 only "
                             "(tensor parallelism is not ported; for data "
                             "parallelism launch under torchrun "
                             "--nproc_per_node N).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to train on (default cuda).")
    return parser.parse_args(argv)


def train_kwargs(args: argparse.Namespace) -> dict:
    """``tacotron2_torch.train.loop.train``'s arguments from the flags."""
    return dict(metadata_path=args.metadata,
                checkpoint_dir=args.checkpoint_dir, epochs=args.epochs,
                batch_size=args.batch_size, learning_rate=args.lr,
                debug_overfit=args.debug, val_metadata=args.val_metadata,
                resume=args.resume,
                postnet_freeze_steps_override=args.postnet_freeze_steps,
                accum_steps=args.accum_steps, precision=args.precision,
                tensor_parallel=args.tp,
                keep_epoch_ckpts=args.keep_epoch_ckpts, device=args.device)


if __name__ == "__main__":
    from tacotron2_torch.train.loop import train
    train(**train_kwargs(parse_args()))
