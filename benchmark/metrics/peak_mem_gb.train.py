"""The most device memory the allocator held during the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GB."""


def read(session, driver):
    return session.peak_window_bytes / 1e9
