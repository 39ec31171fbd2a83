"""BigVGAN's share of its roofline (%): the least time of the work the
delivered audio needs (each row's frames to its stop, ``frame_ends``,
``counts/bigvgan.py``: the convolutions' operations at TF32's peak plus
the activations' at fp32's, or the weights once a call and each frame's
mel and samples over 3.35 TB/s where that is longer) over the device's
busy time inside the program's ``vocoder`` spans.  The padding and the
masked tail the program also vocodes show as a lower share.  None for a
program without the spans."""

from benchmark.counts import bigvgan as K
from benchmark.counts.peaks import FLOPS, HBM_BYTES_PER_S
from benchmark.harness.program_spans import device_busy_s


def read(session, driver):
    busy = device_busy_s(session, "vocoder")
    if busy is None or busy <= 0:
        return None
    h = session.cell.config["bigvgan"]
    least = 0.0
    for c in driver.recorder.calls:
        rows = [int(e) for e in c["frame_ends"]]
        frames = sum(rows)
        compute = (K.frame(h) * frames / FLOPS["tf32"]
                   + K.act_ops(h, frames) / FLOPS["float32"])
        least += max(compute, K.nbytes(h, rows) / HBM_BYTES_PER_S)
    return 100.0 * least / busy
