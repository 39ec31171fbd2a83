"""Batched token -> mel synthesis, the port's serving entry point.

Counterpart of ``tacotron2_tpu/infer/synthesize.py::synthesize_mels``
from token ids on (the text frontend is a later slice of the port).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.tacotron2 import Tacotron2, make_speaker_ids, tacotron2_infer
from ..text.frontend import pad_sequences


def synthesize_mels(model: Tacotron2, token_seqs: Sequence[Sequence[int]],
                    max_steps: Optional[int] = None,
                    gate_threshold: Optional[float] = None,
                    speaker_id=None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Token-id sequences -> list of (T_i, n_mels) postnet mels, each
    trimmed at its own gate stop, and the alignments (B, n_frames, T_enc).

    The batch is padded to a multiple of 16 tokens and the padding masked.
    One sequence decodes with the "any" stop rule, a batch with "all"
    (until every item's gate has fired).
    """
    tokens, lengths = pad_sequences(token_seqs, pad_multiple=16)
    speaker_ids = make_speaker_ids(speaker_id, len(token_seqs), model.cfg)
    out, n_frames, frame_ends = tacotron2_infer(
        model, tokens, max_steps=max_steps, gate_threshold=gate_threshold,
        text_lengths=lengths, speaker_ids=speaker_ids,
        stop_mode="all" if len(token_seqs) > 1 else "any", device=device)
    n = int(n_frames)
    mel_post = out.mel_postnet[:, :n].cpu().numpy()
    if n < 3:
        print(f"[WARN] Very short mel length ({n}) - possible premature "
              f"stop. Gate threshold={model.cfg.gate_threshold}")
    ends = frame_ends.cpu().numpy()
    mels = [mel_post[b, :int(ends[b])] for b in range(mel_post.shape[0])]
    return mels, out.alignments[:, :n].cpu().numpy()
