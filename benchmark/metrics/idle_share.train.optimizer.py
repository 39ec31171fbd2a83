"""The device's idle share of the window (%) while the program's span
``optimizer`` was the innermost program span in flight: the clip and Adam
over the parameters (``train/optim.py::Optimizer.update``)."""

from benchmark.harness.program_spans import idle_share


def read(session, driver):
    return idle_share(session, "optimizer")
