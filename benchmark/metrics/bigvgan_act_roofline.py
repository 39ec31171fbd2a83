"""BigVGAN's anti-aliased activations' share of their roofline (%): the
least time of the activations the delivered audio needs (each row's frames
to its stop, ``frame_ends``, ``counts/bigvgan.py``: their inputs read and
their outputs written once over 3.35 TB/s, or their operations at fp32's
peak where that is longer) over the device's busy time inside the
program's ``bigvgan.act`` spans.  The padding and the masked tail the
program also vocodes show as a lower share.  None for a program without
the spans."""

from benchmark.counts import bigvgan as K
from benchmark.harness.program_spans import device_busy_s
from benchmark.harness.readings import least_time_s


def read(session, driver):
    busy = device_busy_s(session, "bigvgan.act")
    if busy is None or busy <= 0:
        return None
    h = session.cell.config["bigvgan"]
    least = 0.0
    for c in driver.recorder.calls:
        frames = sum(int(e) for e in c["frame_ends"])
        least += least_time_s(K.act_ops(h, frames), K.act_bytes(h, frames),
                              "float32")
    return 100.0 * least / busy
