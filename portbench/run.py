"""Run one cell of the benchmark once and print its result as the last line of standard
output (the numbers compared, each with its limit, as the last lines of standard error):

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds dsc_tpu_torch, on a machine with an NVIDIA GPU. The
kernels build once into build/kernels/ inside the checkout and load from there afterwards.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    # the checkout's root, in place of this script's folder (whose trace.py is not the
    # standard library's); kernel caches at fixed places inside the checkout
    sys.path[0] = str(ROOT)
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
        os.environ[var] = str(ROOT / 'build' / 'portbench_cache' / sub)

    import torch

    from portbench import harness, registry

    cell = registry.workload(a.workload)
    if not torch.cuda.is_available():
        print('portbench: no CUDA device (torch.cuda.is_available() is false)', file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell['chips']:
        print(f'portbench: {a.workload} needs {cell["chips"]} cards, '
              f'{torch.cuda.device_count()} found', file=sys.stderr)
        return 2
    import dsc_tpu_torch

    if ROOT not in Path(dsc_tpu_torch.__file__).resolve().parents:
        print(f'portbench: dsc_tpu_torch comes from {dsc_tpu_torch.__file__}, not from this '
              f'checkout ({ROOT})', file=sys.stderr)
        return 2
    result = harness.run(a.workload, a.seed, a.seconds, bool(a.trace), T0, 'cuda', cell)
    found = harness.forbidden_modules()
    if found:
        print(f'portbench: the run loaded {", ".join(found)}', file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in harness.check_lines(result['checks']):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == '__main__':
    sys.exit(main())
