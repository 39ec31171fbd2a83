"""Kernel #5's share of its roofline (%): least time of the window's
eight launches a forward (the encoder's three over the rows' tokens, the
postnet's five over each row's frames to its stop; fp32) over their
device time."""

from benchmark.counts import conv_bn_act as k5
from benchmark.harness.readings import least_time_s, roofline_share


def read(session, driver):
    m = session.cell.config["model"]
    least = 0.0
    for c in driver.recorder.calls:
        tokens, frames = int(c["lengths"].sum()), int(c["frame_ends"].sum())
        for shape in k5.launches(m, tokens, frames):
            least += least_time_s(k5.ops(*shape), k5.nbytes(*shape, 4),
                                  "float32")
    return roofline_share(session, "conv_bn_act_", least)
