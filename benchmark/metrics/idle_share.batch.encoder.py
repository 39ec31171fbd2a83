"""The device's idle share of the window (%) while the program's span
``encoder`` was the innermost program span in flight: the eval encoder of
``synthesize_wav`` (three #5 launches, the BiLSTM as a host loop)."""

from benchmark.harness.program_spans import idle_share


def read(session, driver):
    return idle_share(session, "encoder")
