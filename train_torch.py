#!/usr/bin/env python3
"""Train the PyTorch port of Tacotron 2 on one CUDA card, or data- and
tensor-parallel on N cards.

The flags are ``train.py``'s, with the same meanings but one, plus
``--device``:

    python train_torch.py processed/metadata.csv checkpoints/run1 \\
        --epochs 100 --batch_size 16 --lr 1e-3 [--debug] \\
        [--val_metadata V.csv] [--resume CKPT] [--postnet_freeze_steps N] \\
        [--accum_steps N] [--precision bf16|fp32] [--remat off|full|dots] \\
        [--keep_epoch_ckpts N] [--tp N] [--device cuda|cpu]

On N cards, the same flags under torchrun, one rank a card (NCCL); each
rank loads ``--batch_size`` rows of every global batch of
``batch_size * N``, and each step is the one a single process takes on
the global batch:

    torchrun --nproc_per_node N train_torch.py processed/metadata.csv \\
        checkpoints/run1 --batch_size 16 ...

With ``--tp N`` the ranks form a ``data=D x model=N`` grid (launch
``--nproc_per_node D*N``; rank r at data index r // N, model index r % N):
each rank holds its shard of the decoder LSTMs' gates and of the output
heads, the global micro-batch stays ``batch_size`` times the number of
processes, and the step is the one a single process takes on it:

    torchrun --nproc_per_node 4 train_torch.py processed/metadata.csv \
        checkpoints/run1 --batch_size 16 --tp 2 ...

More ranks than cards share the cards over gloo (two ranks on one card
check the path; they are no faster than one process).  Rank 0 writes the
log and the checkpoints, which have the unsharded layout whatever ``--tp``.

``--resume`` takes a checkpoint directory of the port, an Orbax checkpoint
directory of the JAX package or the reference's PyTorch checkpoint file.
It differs from ``train.py``'s in one point: resumed from
``tacotron2_epoch_N`` (or a ``best_model`` saved after epoch N), the port
goes on at epoch N + 1, where ``train.py`` runs epoch N again; so
``--epochs E`` from there trains E - N epochs here and E - N + 1 there.
``--remat full|dots`` runs each step of the decoder's step loop inside
``torch.utils.checkpoint`` and turns the split BPTT off, as ``train.py``'s
flag does with ``jax.checkpoint``.
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
    parser.add_argument("--remat", type=str, default=None,
                        choices=["off", "full", "dots"],
                        help="Decoder-step rematerialization for the "
                             "backward pass: 'full' recomputes the whole "
                             "step, 'dots' keeps matmul outputs and "
                             "recomputes elementwise ops. Use when large "
                             "--batch_size overflows HBM (default: config).")
    parser.add_argument("--keep_epoch_ckpts", type=int, default=None,
                        help="Keep only the newest N per-epoch checkpoints "
                             "(default 5; 0 keeps all).")
    parser.add_argument("--tp", type=int, default=1,
                        help="Tensor-parallel width N: the decoder's LSTM "
                             "gates and output heads sharded over N ranks "
                             "(launch under torchrun --nproc_per_node D*N "
                             "for D data-parallel replicas; N must divide "
                             "the ranks).")
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
                remat=args.remat, tensor_parallel=args.tp,
                keep_epoch_ckpts=args.keep_epoch_ckpts, device=args.device)


if __name__ == "__main__":
    from tacotron2_torch.train.loop import train
    train(**train_kwargs(parse_args()))
