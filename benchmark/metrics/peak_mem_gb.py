"""Peak device memory allocated over set-up and window, GB (10^9 bytes):
``torch.cuda.max_memory_allocated``."""


def read(rec):
    return None if rec.peak_bytes is None else rec.peak_bytes / 1e9
