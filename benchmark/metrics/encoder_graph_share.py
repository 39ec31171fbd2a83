"""The share of the encoder's calls that the program served by replaying
a CUDA graph of its BiLSTM (%): 100 x its counter
``encoder.graph_replays`` over ``encoder.calls`` in the window.  One
reader for every cell's part (``encoder_graph_share.train``,
``encoder_graph_share.batch``).  None for a program without the
counters."""

from benchmark.harness.program_spans import counter


def read(session, driver):
    calls = counter("encoder.calls")
    if calls <= 0:
        return None
    return 100.0 * counter("encoder.graph_replays") / calls
