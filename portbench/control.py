"""The readings a cell's limit is set from, at the cell's own size on the card: the number
the configuration compares, read for the program on each of ``--seeds`` and for the control
(the plain reference in bfloat16, put in the program's place) on each of ``--control-seeds``.
One JSON line a seed; the benchmark's own runs never run this.

    python portbench/control.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _seeds(text: str):
    return [int(s) for s in text.split(',') if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=_seeds, default=[])
    p.add_argument('--control-seeds', type=_seeds, default=[])
    p.add_argument('--device', default='cuda')
    a = p.parse_args(argv)
    sys.path[0] = str(ROOT)

    import torch

    from portbench import compare, registry
    from portbench.harness import quiet

    cell = registry.workload(a.workload)
    cfg = registry.config(cell['config'])
    pipe, ref = registry.pipeline(cfg), registry.reference(cfg)
    checks = cfg['checks']

    def line(seed, side, values):
        print(json.dumps({'workload': a.workload, 'seed': seed, 'side': side, **values}),
              flush=True)

    state = pipe.setup(cfg, cell, a.device)
    for seed in a.seeds:
        # the program's reading: the largest over the pool's inputs
        worst = {c['name']: 0.0 for c in checks}
        for r in pipe.make_inputs(cfg, cell, seed, a.device):
            got = pipe.result(pipe.call(state, pipe.prepare(state, r), quiet))
            want = ref.run(cfg, r)
            for c in checks:
                worst[c['name']] = max(worst[c['name']], compare.gap(c['kind'], got, want))
            del got, want
        line(seed, 'program', worst)
    for seed in a.control_seeds:
        # the control's reading: the smallest over the pool's inputs
        least = {c['name']: float('inf') for c in checks}
        for r in pipe.make_inputs(cfg, cell, seed, a.device):
            got, want = ref.control(cfg, r), ref.run(cfg, r)
            for c in checks:
                least[c['name']] = min(least[c['name']], compare.gap(c['kind'], got, want))
            del got, want
        line(seed, 'control', least)
    pipe.teardown()
    if a.device == 'cuda':
        torch.cuda.synchronize()
    return 0


if __name__ == '__main__':
    sys.exit(main())
