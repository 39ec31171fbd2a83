"""Alignment heatmaps.

Counterpart of ``tacotron2_tpu/utils/plotting.py``.  Where matplotlib
imports, the same figure as the JAX package's; where it does not (the
card's machine has none), the heatmap alone as an 8-bit grayscale PNG
written with ``zlib`` and ``struct``: one pixel a cell, decoder steps
upward, black at the matrix's minimum and white at its maximum.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _matrix(alignments, sample_index: int) -> np.ndarray:
    if hasattr(alignments, "detach"):             # a torch tensor
        alignments = alignments.detach().float().cpu().numpy()
    a = np.asarray(alignments, np.float32)
    if sample_index >= a.shape[0]:
        sample_index = 0
    return a[sample_index]                        # (T_dec, T_enc)


def write_gray_png(path: str, pixels: np.ndarray) -> None:
    """Write a (height, width) uint8 array as a grayscale PNG."""
    h, w = pixels.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = b"".join(b"\x00" + bytes(r) for r in np.ascontiguousarray(
        pixels, np.uint8))                        # filter 0 on every row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows))
                + chunk(b"IEND", b""))


def heatmap_pixels(matrix: np.ndarray) -> np.ndarray:
    """(T_dec, T_enc) -> uint8 rows top to bottom, decoder step 0 last."""
    lo, hi = float(matrix.min()), float(matrix.max())
    scaled = (matrix - lo) / (hi - lo) if hi > lo else np.zeros_like(matrix)
    return np.round(scaled[::-1] * 255).astype(np.uint8)


def save_alignment_plot(alignments, path: str, sample_index: int = 0) -> None:
    """Save a (T_dec, T_enc) attention heatmap PNG for one sample of
    ``alignments`` (B, T_dec, T_enc) (numpy or torch)."""
    matrix = _matrix(alignments, sample_index)
    try:
        import matplotlib
    except ImportError:
        write_gray_png(path, heatmap_pixels(matrix))
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 6))
    im = ax.imshow(matrix, aspect="auto", origin="lower",
                   interpolation="none", cmap="viridis")
    fig.colorbar(im, ax=ax)
    plt.xlabel("Encoder timestep (Phonemes)")
    plt.ylabel("Decoder timestep")
    plt.title(f"Attention Alignment (sample {sample_index})")
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)
