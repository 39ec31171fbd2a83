"""Kernel #3's share of its roofline (%): least time of the window's
launches (one a step, counted at the rows' true lengths) over their
device time."""

from benchmark.counts import decoder_train_fwd as k3
from benchmark.harness.readings import (dtype_bytes, least_time_s,
                                        roofline_share, train_precision)


def read(session, driver):
    m = session.cell.config["model"]
    p = train_precision(session.cell.config)
    least = 0.0
    for st in driver.steps:
        rows = list(zip(st["text_lengths"], st["mel_lengths"]))
        least += least_time_s(k3.ops(m, rows),
                              k3.nbytes(m, rows, dtype_bytes(p)), p)
    return roofline_share(session, "decoder_train_fwd_kernel", least)
