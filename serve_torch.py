#!/usr/bin/env python3
"""Run the TTS HTTP server of the PyTorch port on one CUDA card.

The flags are ``serve.py``'s, plus ``--device``:

    python serve_torch.py --checkpoint checkpoints/r4_synth_bf16 \\
        [--port 8080] [--bf16] [--max_batch 16] [--device cuda|cpu]

    curl -X POST localhost:8080/synthesize \\
         -d '{"text": "Hello world.", "vocoder": "griffinlim"}' -o out.wav
    curl -N -X POST localhost:8080/synthesize_streaming \\
         -d '{"text": "Hello world.", "chunk_frames": 64}' -o out.pcm

``--checkpoint`` takes what ``infer/synthesize.py::load_model`` reads: an
Orbax checkpoint directory of the JAX package, a checkpoint directory of
the port or the port's weights file.  SIGINT (Ctrl-C) or SIGTERM stops the
server after the requests in flight, and the process exits 0.
"""

import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--griffinlim_iters", type=int, default=60)
    parser.add_argument("--n_speakers", type=int, default=1,
                        help="Speaker-table size of the checkpoint "
                             "(must match training).")
    parser.add_argument("--bf16", action="store_true",
                        help="Serve with bfloat16 weights (half the weight "
                             "memory and bytes a decode step).")
    parser.add_argument("--max_batch", type=int, default=16,
                        help="Dynamic micro-batching: coalesce up to this "
                             "many concurrent requests into one batched "
                             "decode (1 = per-request serving).")
    parser.add_argument("--batch_window_ms", type=float, default=0.0,
                        help="Wait this long after a request arrives for "
                             "batch-mates (0 = drain-only: batch whatever "
                             "queued while the device was busy; zero "
                             "added latency when idle).")
    parser.add_argument("--max_queue", type=int, default=64,
                        help="Backpressure bound: at most this many "
                             "requests wait for the batching worker; "
                             "beyond it requests are shed with 503 + "
                             "Retry-After instead of queueing without "
                             "bound.")
    parser.add_argument("--request_timeout_s", type=float, default=None,
                        help="Bound a request's total service time "
                             "(queue wait + decode); expiry returns 504 "
                             "and frees the batch slot. Default: no "
                             "timeout.")
    parser.add_argument("--vocoder_chunk_frames", type=int, default=None,
                        help="Vocode mels in exact receptive-field-"
                             "overlapped chunks of this many frames: "
                             "bounds HiFi-GAN's peak activation memory "
                             "for large --max_batch / long utterances "
                             "(identical audio, small compute overlap).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to serve on (default cuda).")
    args = parser.parse_args(argv)
    if (args.vocoder_chunk_frames is not None
            and args.vocoder_chunk_frames < 1):
        parser.error("--vocoder_chunk_frames must be >= 1")
    return args


def serve_kwargs(args: argparse.Namespace) -> dict:
    """``tacotron2_torch.infer.server.serve``'s arguments from the flags."""
    import dataclasses

    from tacotron2_torch.config import Config
    cfg = None
    if args.n_speakers > 1:
        base = Config()
        cfg = dataclasses.replace(
            base, model=dataclasses.replace(base.model,
                                            n_speakers=args.n_speakers))
    return dict(checkpoint_path=args.checkpoint, host=args.host,
                port=args.port, cfg=cfg,
                griffinlim_iters=args.griffinlim_iters, bf16=args.bf16,
                max_batch=args.max_batch,
                batch_window_ms=args.batch_window_ms,
                vocoder_chunk_frames=args.vocoder_chunk_frames,
                max_queue=args.max_queue,
                request_timeout_s=args.request_timeout_s,
                device=args.device)


def _interrupt(signum, frame):
    raise KeyboardInterrupt


if __name__ == "__main__":
    import signal

    from tacotron2_torch.infer.server import serve
    signal.signal(signal.SIGTERM, _interrupt)   # serve() stops as on Ctrl-C
    serve(**serve_kwargs(parse_args()))
