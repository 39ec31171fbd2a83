"""Configuration of the PyTorch port: the model and audio constants.

An own copy of the JAX package's configuration (``tacotron2_tpu/config.py``)
holding the fields the port's serving path reads, with the same values so
that both packages build the same model.  The TPU-only training knobs of the
JAX config (scan unrolling, rematerialisation, split BPTT) are not carried
over; the training slice adds what it needs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# 72 symbols: 69 ARPAbet phonemes with stress markers, plus space, period,
# comma.  Token ids index this table.
SYMBOLS: Tuple[str, ...] = (
    'AA0', 'AA1', 'AA2', 'AE0', 'AE1', 'AE2', 'AH0', 'AH1', 'AH2',
    'AO0', 'AO1', 'AO2', 'AW0', 'AW1', 'AW2', 'AY0', 'AY1', 'AY2',
    'B', 'CH', 'D', 'DH', 'EH0', 'EH1', 'EH2', 'ER0', 'ER1', 'ER2',
    'EY0', 'EY1', 'EY2', 'F', 'G', 'HH', 'IH0', 'IH1', 'IH2', 'IY0',
    'IY1', 'IY2', 'JH', 'K', 'L', 'M', 'N', 'NG', 'OW0', 'OW1',
    'OW2', 'OY0', 'OY1', 'OY2', 'P', 'R', 'S', 'SH', 'T', 'TH',
    'UH0', 'UH1', 'UH2', 'UW0', 'UW1', 'UW2', 'V', 'W', 'Y', 'Z', 'ZH',
    ' ', '.', ','
)

SYMBOL_TO_ID = {s: i for i, s in enumerate(SYMBOLS)}
N_SYMBOLS = len(SYMBOLS)


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Audio/DSP parameters."""
    sampling_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    mel_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Tacotron 2 architecture parameters."""
    n_symbols: int = N_SYMBOLS
    symbols_embedding_dim: int = 512

    # Encoder
    encoder_n_convolutions: int = 3
    encoder_embedding_dim: int = 512
    encoder_kernel_size: int = 5

    # Decoder
    n_mels: int = 80
    decoder_rnn_dim: int = 1024
    prenet_dim: int = 256
    max_decoder_steps: int = 1000
    gate_threshold: float = 0.5

    # Attention
    attention_rnn_dim: int = 1024
    attention_dim: int = 128
    location_n_filters: int = 32
    location_kernel_size: int = 31
    energy_scale_init: float = 1.2
    gate_bias_init: float = -3.0

    # PostNet
    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5

    # Multi-speaker conditioning
    n_speakers: int = 1
    speaker_embedding_dim: int = 64

    batchnorm_eps: float = 1e-5

    # Decode CUDA tensors with the persistent decode kernel
    # (ops/decoder_megakernel.py); False runs the step loop, whose
    # attention tail is the Triton kernel (ops/attention_kernel.py).
    decoder_megakernel: bool = True


@dataclasses.dataclass(frozen=True)
class Config:
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)


DEFAULT_CONFIG = Config()
