"""Example protocol workloads of the port.

Each module is a copy of the packed model of the JAX package's example
of the same name (``stateright_tpu/examples/``) with ``main()`` and its
subcommands: ``check`` and ``check-sym`` run the host DFS engine, as
the JAX package's do; ``check-gpu`` is the counterpart of ``check-tpu``
(``spawn_gpu()``, raced against a budgeted host BFS; ``--no-race``
runs the card alone, ``--cpu`` the kernels' plain versions); each
writes ``report()``'s lines. ``explore`` (the Explorer) is not ported
and exits non-zero.
"""

from __future__ import annotations

import sys


def not_ported(module: str, cmd: str) -> int:
    """The message and exit status of a subcommand whose service the port
    lacks."""
    print(f"{module} {cmd}: the Explorer is not ported to "
          "stateright_tpu_torch (ROADMAP A12); use check or check-gpu",
          file=sys.stderr)
    return 2


def parse_args(argv):
    """``(command, thread count, gpu_options)`` of an example's command
    line: ``<command> [THREAD_COUNT] [--cpu] [--no-race]``."""
    args = list(sys.argv[1:] if argv is None else argv)
    flags = {"--cpu": ("device", "cpu"), "--no-race": ("race", False)}
    opts = dict(flags[a] for a in args if a in flags)
    args = [a for a in args if a not in flags]
    cmd = args[0] if args else None
    count = int(args[1]) if len(args) > 1 else 3
    return cmd, count, opts
