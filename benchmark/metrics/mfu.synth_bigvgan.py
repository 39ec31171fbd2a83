"""The synthesis step's share of the card's peak (%) with BigVGAN: as
``mfu.synth``, the operations of the audio delivered (each row to its gate
stop: encoder over its tokens, prenet, decoder step and postnet a frame
at fp32's peak, BigVGAN's convolution operations a frame,
``counts/bigvgan.py``, at TF32's) over the window."""

from benchmark.counts import bigvgan, tacotron2
from benchmark.counts.peaks import FLOPS


def read(session, driver):
    cfg = session.cell.config
    m = cfg["model"]
    voc = bigvgan.frame(cfg["bigvgan"])
    least = 0.0
    for c in driver.recorder.calls:
        for tokens, frames in zip(c["lengths"], c["frame_ends"]):
            least += (tacotron2.forward(m, int(tokens), int(frames))
                      / FLOPS["float32"] + int(frames) * voc / FLOPS["tf32"])
    return 100.0 * least / session.trace.window_s
