"""Build the port's C front door and its C++ harness, and run the harness.

    python3 -m dsc_tpu_torch.cpp.build [--out DIR] [--run] [--device cuda|cpu]

compiles ``dsc_shim.cpp`` (beside this file) against the unchanged
``cpp/include/dsc.h`` into ``DIR/libdsc_tpu_torch_c.so``, and the unchanged
``cpp/tests/test_filterfft.cpp`` against that library into
``DIR/test_filterfft``, with ``g++ -std=c++20`` and the flags of
``python3-config --includes`` and ``--ldflags --embed`` (cpp/Makefile's).
DIR defaults to ``build/cpp`` under the repository root, which git
ignores. ``--run`` then runs the harness, which prints "ALL OK" when every
check passes, on the card or (``--device cpu``) on the CPU: the C ABI has
no device argument, so the device reaches ``capi.ctx_init`` as
``DSC_DEVICE``. The embedded interpreter finds the port and this
interpreter's packages through ``PYTHONPATH``.
"""

from __future__ import annotations

import argparse
import os
import shlex
import site
import subprocess
import sys
from pathlib import Path
from typing import List, Tuple

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
INCLUDE = REPO / 'cpp' / 'include'
HARNESS = REPO / 'cpp' / 'tests' / 'test_filterfft.cpp'
OUT_DIR = REPO / 'build' / 'cpp'
LIB_NAME = 'dsc_tpu_torch_c'
CXXFLAGS = ('-std=c++20', '-O2', '-fPIC', '-Wall', '-Wextra', '-Wshadow')


def _config(*flags: str) -> List[str]:
    out = subprocess.run(['python3-config', *flags], check=True, capture_output=True,
                         text=True).stdout
    return shlex.split(out)


def _run(cmd: List[str]) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'{" ".join(cmd)} failed:\n{proc.stdout}{proc.stderr}')


def build(out_dir: Path = OUT_DIR) -> Path:
    """Compile the shim library and the harness into ``out_dir``; returns
    the harness's path. Raises with the compiler's output on failure."""
    out_dir.mkdir(parents=True, exist_ok=True)
    includes, ldflags = _config('--includes'), _config('--ldflags', '--embed')
    lib = out_dir / f'lib{LIB_NAME}.so'
    _run(['g++', *CXXFLAGS, '-shared', str(HERE / 'dsc_shim.cpp'), '-o', str(lib),
          f'-I{INCLUDE}', *includes, *ldflags])
    harness = out_dir / 'test_filterfft'
    _run(['g++', *CXXFLAGS, str(HARNESS), '-o', str(harness), f'-I{INCLUDE}',
          f'-L{out_dir}', f'-l{LIB_NAME}', *ldflags, '-Wl,-rpath,$ORIGIN'])
    return harness


def python_path() -> str:
    """The repository, this interpreter's package directories and any
    PYTHONPATH already set: what the embedded interpreter must import."""
    dirs = [str(REPO), *site.getsitepackages(), *[p for p in sys.path if p.endswith(
        ('site-packages', 'dist-packages'))]]
    if os.environ.get('PYTHONPATH'):
        dirs.append(os.environ['PYTHONPATH'])
    return os.pathsep.join(dict.fromkeys(dirs))


def run(harness: Path, device: str = 'cuda', timeout: float = 600) -> Tuple[int, str]:
    """Run the harness with ``DSC_DEVICE=device``; (exit code, output)."""
    env = dict(os.environ, PYTHONPATH=python_path(), DSC_DEVICE=device)
    proc = subprocess.run([str(harness)], env=env, capture_output=True, text=True,
                          timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--out', type=Path, default=OUT_DIR, help='output directory')
    parser.add_argument('--run', action='store_true', help='run the harness after the build')
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                        help='the device the harness runs on (DSC_DEVICE)')
    args = parser.parse_args()
    harness = build(args.out)
    print(f'built {harness}')
    if not args.run:
        return 0
    rc, out = run(harness, args.device)
    print(out, end='')
    return rc


if __name__ == '__main__':
    sys.exit(main())
