"""Configuration of the PyTorch port: the model and audio constants.

An own copy of the JAX package's configuration (``tacotron2_tpu/config.py``)
holding the fields the port reads, with the same values so that both
packages build the same model and train it on the same schedule.  The
decoder-step rematerialisation knobs are carried over
(``torch.utils.checkpoint`` is ``jax.checkpoint``, a selective-checkpoint
policy that saves matrix products is ``dots_saveable``); the scan's
unrolling has no eager meaning and is left out.
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
    p_attention_dropout: float = 0.1
    p_decoder_dropout: float = 0.1
    p_prenet_dropout: float = 0.5
    p_postnet_dropout: float = 0.5

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

    # BatchNorm running-statistics momentum (torch nn.BatchNorm1d default)
    batchnorm_momentum: float = 0.1
    batchnorm_eps: float = 1e-5

    # Split-BPTT backward for the teacher-forced decoder
    # (ops/decoder_bptt.py): the reverse pass emits per-step gate gradients
    # and the weight gradients are time-batched products after the loop.
    # False differentiates the plain step loop with torch.autograd.
    decoder_split_bptt: bool = True

    # Recompute each decoder step of the step loop in the backward instead
    # of keeping its activations (models/decoder.py::decoder_teacher_forced,
    # train mode only); an explicit request turns the split BPTT off, as
    # in the JAX package.  Policy "full" recomputes the whole step, "dots"
    # keeps the matrix products' outputs and recomputes the rest.
    remat_decoder_step: bool = False
    decoder_remat_policy: str = "full"

    # Run CUDA tensors through the persistent kernels: the decode kernel
    # (ops/decoder_megakernel.py) when serving, the teacher-forced forward
    # and reverse-chain kernels (ops/decoder_train_kernel.py,
    # ops/decoder_bwd_kernel.py) when training.  False runs the step loops,
    # whose attention tail is a CUDA kernel (ops/attention_kernel.py).
    decoder_megakernel: bool = True

    # Serve the encoder's and the postnet's conv layers through the fused
    # eval-mode Conv1d + BatchNorm + activation (ops/convbn_kernel.py): the
    # CUDA kernel on CUDA tensors, its plain folded version on CPU tensors.
    # False runs the unfused Conv1d -> BatchNorm -> activation chain.  A
    # field of the port only: the JAX package switches its kernel with an
    # environment variable.  Training never takes the fused route.
    fused_convbn: bool = True


@dataclasses.dataclass(frozen=True)
class GuidedAttentionConfig:
    """Diagonal-Gaussian attention guidance schedule."""
    initial_sigma_factor: float = 0.05   # initial sigma = max(3, factor*text_len)
    sigma_warmup_steps: int = 4000       # steps over which sigma anneals to 1.0
    min_sigma: float = 1.0
    max_sigma_cap: float = 20.0
    weight_start: float = 1.0
    min_weight: float = 0.2
    entropy_target: float = 3.5
    kl_clamp: float = 150.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training schedule."""
    seed: int = 1234
    learning_rate: float = 1e-3
    batch_size: int = 16
    epochs: int = 100
    lr_decay_milestones: Tuple[int, ...] = (50000, 100000, 150000)
    lr_decay_gamma: float = 0.8
    attention_lr_multiplier: float = 1.5
    debug_attention_lr_multiplier: float = 2.0
    postnet_freeze_steps: int = 3000
    max_grad_norm: float = 1.0
    save_every_steps: int = 5000
    keep_epoch_ckpts: int = 5
    accumulation_steps: int = 1
    # "bfloat16" keeps fp32 master weights and Adam moments and runs the
    # forward and backward on a bf16 cast of the parameters (products sum
    # in fp32; loss and BatchNorm statistics stay fp32; no loss scaling).
    # "float32" disables the cast.
    precision: str = "bfloat16"
    debug_batch_size: int = 8
    debug_sigma_warmup_steps: int = 800
    debug_success_mel_l1: float = 1.0
    # Padded batch dims are rounded up to these multiples (data/dataset.py)
    text_pad_multiple: int = 32
    mel_pad_multiple: int = 64


@dataclasses.dataclass(frozen=True)
class Config:
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    guided_attention: GuidedAttentionConfig = dataclasses.field(
        default_factory=GuidedAttentionConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


DEFAULT_CONFIG = Config()
