"""WaveGlow's share of its roofline (%): the least time of the work the
delivered audio needs (each row's groups to its stop, ``frame_ends`` x
stride / n_group, ``counts/waveglow.py``: operations at TF32's peak, or
the weights once a call and each group's folded mel, noise and output
over 3.35 TB/s where that is longer) over the device's busy time inside
the program's ``vocoder`` spans.  The padding and the masked tail the
program also vocodes show as a lower share.  None for a program without
the spans."""

from benchmark.counts import waveglow as K
from benchmark.harness.program_spans import device_busy_s
from benchmark.harness.readings import least_time_s


def read(session, driver):
    busy = device_busy_s(session, "vocoder")
    if busy is None or busy <= 0:
        return None
    w = session.cell.config["waveglow"]
    per_frame = w["upsample_stride"] // w["n_group"]
    least = 0.0
    for c in driver.recorder.calls:
        groups = [int(e) * per_frame for e in c["frame_ends"]]
        least += least_time_s(K.ops(w, sum(groups)), K.nbytes(w, groups),
                              "tf32")
    return 100.0 * least / busy
