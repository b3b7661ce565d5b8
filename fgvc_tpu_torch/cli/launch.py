#!/usr/bin/env python
"""Multi-process launcher of the port (fgvc_tpu/cli/launch.py), the
reference's dist_test.sh: N local processes, each told its rank and the
coordinator's address through FGVC_COORDINATOR, FGVC_NUM_PROCESSES and
FGVC_PROCESS_ID:

    python -m fgvc_tpu_torch.cli.launch --nprocs 2 -- \
        python -m fgvc_tpu_torch.cli.test --task davis --data-root <pkls> ...

`fgvc_tpu_torch.cli.test` reads them through
`parallel.dist.initialize_from_flags` and joins a gloo process group at
tcp://localhost:<port>; `fgvc_tpu_torch.cli.train` joins a data-parallel
group (NCCL where every rank has a card of its own, else gloo); any script
can do the same before it touches a card.  Each rank runs on
cuda:{rank % device count} unless given device lists, so on a machine with
one card every rank shares it.  The other entry points would run N
uncoordinated copies.

The launcher imports neither torch nor the package: it spawns the ranks,
polls all of them, terminates the rest as soon as one fails (its exit code
is the launcher's), forwards SIGTERM to every live rank, and exits 130 on
an interrupt.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(nprocs: int, command: list, port: int = 0) -> int:
    """Run `command` nprocs times with the FGVC_* rank variables; returns the
    first nonzero exit code (terminating the ranks still running), else 0."""
    if not command:
        raise ValueError("no command given (separate it with `--`)")
    port = port or _free_port()
    procs = []
    for rank in range(nprocs):
        env = dict(os.environ)
        env["FGVC_COORDINATOR"] = f"localhost:{port}"
        env["FGVC_NUM_PROCESSES"] = str(nprocs)
        env["FGVC_PROCESS_ID"] = str(rank)
        procs.append(subprocess.Popen(command, env=env))
    code = 0

    # a cluster manager's SIGTERM goes to every live rank; the launcher
    # keeps waiting for their exits
    def _forward_sigterm(signum, frame):
        for q in procs:
            if q.poll() is None:
                q.send_signal(signal.SIGTERM)

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _forward_sigterm)
    except ValueError:  # not the main thread
        prev_sigterm = None
    try:
        # poll every rank: a failure of any one ends the others at once (a
        # wait in rank order would sit on rank 0, blocked in the group's
        # rendezvous, while a later rank lies dead)
        live = list(procs)
        while live:
            for p in list(live):
                rc = p.poll()
                if rc is None:
                    continue
                live.remove(p)
                if rc != 0 and code == 0:
                    code = rc
                    for q in procs:
                        if q.poll() is None:
                            q.terminate()
            if live:
                time.sleep(0.2)
    except KeyboardInterrupt:
        for q in procs:
            if q.poll() is None:
                q.send_signal(signal.SIGINT)
        for q in procs:
            q.wait()
        code = 130
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
    return code


def main(argv=None):
    p = argparse.ArgumentParser(
        description="launch N coordinated processes (dist_test.sh equivalent)",
        usage="python -m fgvc_tpu_torch.cli.launch --nprocs N [--port P] -- COMMAND [ARGS...]",
    )
    p.add_argument("--nprocs", type=int, required=True)
    p.add_argument("--port", type=int, default=0,
                   help="coordinator port (default: pick a free one)")
    args, rest = p.parse_known_args(argv)
    if rest and rest[0] == "--":
        rest = rest[1:]
    sys.exit(launch(args.nprocs, rest, port=args.port))


if __name__ == "__main__":
    main()
