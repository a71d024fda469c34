"""Peak device memory of the window, GiB: ``torch.cuda.max_memory_allocated``
after a reset at the window's opening (the prepared state included)."""


def read(run):
    peak = run.get("window_peak_bytes")
    return None if peak is None else peak / 2.0 ** 30
