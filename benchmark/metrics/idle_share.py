"""The device's idle share of the window (%): one minus the union of the
traced device events' intervals over the window.  One reader for every
cell's part (``idle_share.train``, ``idle_share.batch``)."""


def read(session, driver):
    t = session.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
