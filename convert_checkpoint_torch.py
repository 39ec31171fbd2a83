#!/usr/bin/env python3
"""Convert checkpoints between the reference PyTorch implementation and
the PyTorch port, without JAX.

The counterpart of ``convert_checkpoint.py``, whose ``torch2jax`` is
``reference2port`` here and ``jax2torch`` is ``port2reference``:

    # the reference's .pth (its train.py dict or a bare state_dict)
    # -> a params-only checkpoint of the port (a directory, weights.pt)
    python convert_checkpoint_torch.py reference2port tacotron2_epoch_5.pth ckpt_dir/

    # any checkpoint the port reads (its own, full or params-only; an Orbax
    # directory of the JAX package) -> a reference-layout .pth
    python convert_checkpoint_torch.py port2reference ckpt_dir/ model.pth

Both use the default (single-speaker) model, as ``convert_checkpoint.py``
does; the reference has no speaker tables.
"""

import argparse

DIRECTIONS = {"reference2port": "torch2jax", "port2reference": "jax2torch"}


def reference2port(src: str, dst: str) -> None:
    import torch

    from tacotron2_torch.config import ModelConfig
    from tacotron2_torch.models.tacotron2 import Tacotron2
    from tacotron2_torch.train.checkpoint import save_params_only
    from tacotron2_torch.utils.torch_compat import load_reference_state_dict

    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    model = load_reference_state_dict(Tacotron2(ModelConfig()), sd)
    save_params_only(dst, model)
    print(f"Converted {src} -> {dst} "
          f"({sum(v.numel() for v in sd.values()):,} params)")


def port2reference(src: str, dst: str) -> None:
    import torch

    from tacotron2_torch.config import ModelConfig
    from tacotron2_torch.models.tacotron2 import Tacotron2
    from tacotron2_torch.utils.torch_compat import torch_state_dict_from_params
    from tacotron2_torch.utils.weight_files import load_weights
    from tacotron2_torch.utils.weights import export_jax_params

    model = load_weights(src, Tacotron2(ModelConfig()))
    sd_np = torch_state_dict_from_params(*export_jax_params(model),
                                         ModelConfig())
    sd = {k: torch.from_numpy(v.copy()) for k, v in sd_np.items()}
    torch.save({"model_state_dict": sd}, dst)
    print(f"Converted {src} -> {dst} ({len(sd)} tensors)")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="reference2port is convert_checkpoint.py's torch2jax, "
                    "port2reference its jax2torch.")
    parser.add_argument("direction", choices=list(DIRECTIONS),
                        help="reference2port (= torch2jax): the reference's "
                             ".pth -> the port's checkpoint directory; "
                             "port2reference (= jax2torch): a checkpoint the "
                             "port reads -> a reference-layout .pth")
    parser.add_argument("src", type=str)
    parser.add_argument("dst", type=str)
    args = parser.parse_args(argv)
    if args.direction == "reference2port":
        reference2port(args.src, args.dst)
    else:
        port2reference(args.src, args.dst)


if __name__ == "__main__":
    main()
