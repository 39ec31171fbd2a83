"""Kernel #2's share of its roofline (%): least time of the window's
decodes, each row over its own tokens to its own stop (the dropped first
frame included, fp32), over their device time."""

from benchmark.counts import decoder_infer as k2
from benchmark.harness.readings import least_time_s, roofline_share


def read(session, driver):
    m = session.cell.config["model"]
    least = 0.0
    for c in driver.recorder.calls:
        rows = [(t, int(e) + 1) for t, e in zip(c["lengths"],
                                                c["frame_ends"])]
        least += least_time_s(k2.ops(m, rows), k2.nbytes(m, rows, 4),
                              "float32")
    return roofline_share(session, "decoder_infer_kernel", least)
