"""setup_s: seconds from the process's start to the first timed call (import, CUDA
initialisation, kernel build or load, the pool, plans, warm-up)."""


def read(record):
    return record['setup_s']
