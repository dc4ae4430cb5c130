"""Example protocol workloads of the port.

Each module is a copy of the packed model of the JAX package's example
of the same name (``stateright_tpu/examples/``) with ``main()`` and its
subcommands: ``check-gpu`` is the counterpart of ``check-tpu`` (the GPU
engine, ``spawn_gpu()``; ``--cpu`` runs the kernels' plain versions);
the subcommands whose engines are not ported say so and exit non-zero.
"""

from __future__ import annotations

import sys
import time


def check_gpu(builder, out=sys.stdout) -> int:
    """Run ``builder.spawn_gpu()`` to the end and write the JAX
    package's ``report()`` summary: the counts, then one line per
    discovery with its witness path. Returns the exit status (0)."""
    start = time.monotonic()
    ck = builder.spawn_gpu().join()
    elapsed = time.monotonic() - start
    out.write(f"Done. states={ck.state_count()}, "
              f"unique={ck.unique_state_count()}, sec={int(elapsed)}\n")
    for name, path in ck.discoveries().items():
        out.write(f'Discovered "{name}" '
                  f"{ck.discovery_classification(name)} {path}")
    return 0


def not_ported(module: str, cmd: str) -> int:
    """The message and exit status of a subcommand whose engine the port
    lacks."""
    print(f"{module} {cmd}: the host engines (dfs, bfs) and the Explorer "
          "are not ported to stateright_tpu_torch; use check-gpu",
          file=sys.stderr)
    return 2


def parse_args(argv):
    """``(command, thread count, options)`` of an example's command
    line: ``<command> [THREAD_COUNT] [--cpu]``."""
    args = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in args
    args = [a for a in args if a != "--cpu"]
    cmd = args[0] if args else None
    count = int(args[1]) if len(args) > 1 else 3
    return cmd, count, dict(device="cpu") if cpu else {}
