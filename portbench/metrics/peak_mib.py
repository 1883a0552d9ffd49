"""peak_mib: the most memory PyTorch's allocator held on the card during the window
(``max_memory_allocated`` after ``reset_peak_memory_stats`` at its start), in MiB."""


def read(record):
    return record['peak_bytes'] / 2**20 if record['peak_bytes'] else None
