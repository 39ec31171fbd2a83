#!/usr/bin/env python3
"""Synthesize speech from text with the PyTorch port, on one CUDA card.

The flags are ``inference.py``'s, plus ``--device``:

    python inference_torch.py "Hello world." --checkpoint ckpt_dir \\
        [--output_dir generated_audio] \\
        [--vocoder hifigan|waveglow|bigvgan|griffinlim] \\
        [--waveglow_checkpoint F] [--bigvgan_checkpoint F] \\
        [--device cuda|cpu]
    python inference_torch.py --input_file input.txt --longform \\
        --checkpoint ...
    python inference_torch.py --batch_file lines.txt --checkpoint ...

``--checkpoint`` takes what ``infer/synthesize.py::load_model`` reads: an
Orbax checkpoint directory of the JAX package, a checkpoint directory of
the port or the port's weights file.  ``--vocoder hifigan`` (the default)
reads the HiFi-GAN generator from ``$HIFIGAN_CHECKPOINT`` or
``./hifigan_checkpoint.pt`` and falls back to Griffin-Lim, with a message,
where there is none.  ``--vocoder waveglow`` reads NVIDIA's WaveGlow
state dict from ``--waveglow_checkpoint``, ``$WAVEGLOW_CHECKPOINT`` or
``./waveglow_checkpoint.pt`` (``models/waveglow.py``), with the same
fallback; ``--vocoder bigvgan`` NVIDIA's BigVGAN generator from
``--bigvgan_checkpoint``, ``$BIGVGAN_CHECKPOINT`` or
``./bigvgan_generator.pt`` (``models/bigvgan.py``), likewise, on the
routes HiFi-GAN takes.
"""

import argparse
import dataclasses
import sys
from typing import List, Optional, Tuple

import numpy as np


def parse_args(argv: Optional[List[str]] = None
               ) -> Tuple[argparse.ArgumentParser, argparse.Namespace]:
    parser = argparse.ArgumentParser()
    parser.add_argument("text", type=str, nargs="?", default=None,
                        help="Text to synthesize.")
    parser.add_argument("--input_file", type=str, default=None,
                        help="Read the text from a file (e.g. a paragraph).")
    parser.add_argument("--longform", action="store_true",
                        help="Sentence-chunked decode for paragraphs "
                             "longer than the decoder cap.")
    parser.add_argument("--batch_file", type=str, default=None,
                        help="File with one text per line: synthesize the "
                             "whole batch in one decode (per-line WAVs).")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Path to a trained model checkpoint.")
    parser.add_argument("--output_dir", type=str, default="generated_audio")
    parser.add_argument("--vocoder", type=str, default="hifigan",
                        choices=["hifigan", "waveglow", "bigvgan",
                                 "griffinlim"])
    parser.add_argument("--waveglow_checkpoint", type=str, default=None,
                        help="NVIDIA WaveGlow checkpoint for --vocoder "
                             "waveglow (default $WAVEGLOW_CHECKPOINT or "
                             "./waveglow_checkpoint.pt).")
    parser.add_argument("--bigvgan_checkpoint", type=str, default=None,
                        help="NVIDIA BigVGAN generator for --vocoder "
                             "bigvgan (default $BIGVGAN_CHECKPOINT or "
                             "./bigvgan_generator.pt).")
    parser.add_argument("--griffinlim_iters", type=int, default=60)
    parser.add_argument("--speaker_id", type=int, default=None,
                        help="Speaker index for multi-speaker checkpoints.")
    parser.add_argument("--n_speakers", type=int, default=1,
                        help="Speaker-table size of the checkpoint "
                             "(must match training).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to synthesize on (default cuda).")
    return parser, parser.parse_args(argv)


def _make_cfg(args):
    from tacotron2_torch.config import Config
    cfg = Config()
    if args.n_speakers > 1:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model,
                                           n_speakers=args.n_speakers))
    return cfg


def main(argv: Optional[List[str]] = None) -> None:
    parser, args = parse_args(argv)
    from tacotron2_torch.dsp.wav import save_wav
    from tacotron2_torch.infer.synthesize import (load_model,
                                                  next_output_path,
                                                  synthesize,
                                                  synthesize_mels)
    from tacotron2_torch.infer.vocode import (GriffinLim, try_load_vocoder,
                                              vocode_mels)

    checkpoint = {"waveglow": args.waveglow_checkpoint,
                  "bigvgan": args.bigvgan_checkpoint}.get(args.vocoder)

    def neural_vocoder():
        """The neural vocoder ``--vocoder`` names, or None for Griffin-Lim
        (asked for, or the fallback)."""
        return try_load_vocoder(args.vocoder, checkpoint, args.device)

    if args.batch_file:
        with open(args.batch_file, "r", encoding="utf-8") as f:
            texts = [line.strip() for line in f if line.strip()]
        if not texts:
            parser.error("--batch_file is empty")
        cfg = _make_cfg(args)
        model = load_model(args.checkpoint, cfg, args.device)
        vocode = (neural_vocoder()
                  or GriffinLim(cfg.audio, args.griffinlim_iters))
        print(f"Batch synthesis: {len(texts)} texts in one decode")
        mels, _ = synthesize_mels(model, texts, speaker_id=args.speaker_id,
                                  device=args.device)
        # One vocoder call per length bucket (not one per line), in
        # chunks, so that WAVs are written as they are made.
        chunk = 16
        for s in range(0, len(mels), chunk):
            part = list(mels[s:s + chunk])
            wavs = vocode_mels(part, cfg.audio, vocode, device=args.device)
            for mel, wav in zip(part, wavs):
                out_path = next_output_path(args.output_dir)
                save_wav(out_path, wav, cfg.audio.sampling_rate)
                print(f"  -> {out_path} ({mel.shape[0]} frames)")
        return

    if args.input_file:
        with open(args.input_file, "r", encoding="utf-8") as f:
            text = f.read().strip()
    elif args.text:
        text = args.text
    else:
        parser.error("provide TEXT, --input_file, or --batch_file")

    if args.longform:
        from tacotron2_torch.infer.longform import synthesize_longform
        cfg = _make_cfg(args)
        model = load_model(args.checkpoint, cfg, args.device)
        # HiFi-GAN, BigVGAN and Griffin-Lim take the proportional route
        # (longform.py), WaveGlow the modular route
        vocode = neural_vocoder()
        wav, mels = synthesize_longform(
            model, text, cfg, vocoder=vocode,
            modular=vocode is not None and args.vocoder == "waveglow",
            griffinlim_iters=args.griffinlim_iters,
            speaker_id=args.speaker_id, device=args.device)
        out_path = next_output_path(args.output_dir)
        save_wav(out_path, np.asarray(wav), cfg.audio.sampling_rate)
        print(f"\nAudio ({len(mels)} sentences, "
              f"{len(wav) / cfg.audio.sampling_rate:.1f}s) saved to: "
              f"{out_path}")
    else:
        synthesize(text=text, checkpoint_path=args.checkpoint,
                   output_dir=args.output_dir, vocoder=args.vocoder,
                   griffinlim_iters=args.griffinlim_iters,
                   cfg=_make_cfg(args), speaker_id=args.speaker_id,
                   device=args.device, vocoder_checkpoint=checkpoint)


if __name__ == "__main__":
    try:
        main()
    except (FileNotFoundError, RuntimeError, ValueError) as e:
        sys.exit(f"error: {e}")
