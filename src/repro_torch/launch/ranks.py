"""Start the ranks of one process group on this host, with a time limit.

:func:`spawn_ranks` runs one command as ``world`` processes and gives each
the environment ``torchrun --standalone`` would (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``), so the command joins with
``init_process_group(init_method="env://")``.  Every rank must exit 0
before the time limit; a rank that fails, or any rank still running at the
limit, fails the spawn at once and every rank left is killed, so a hung
collective cannot hang the caller.
"""

from __future__ import annotations

import os
import socket
import subprocess
import time
from typing import Optional


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(cmd: list[str], world: int, log_dir: str, timeout: float,
                env: Optional[dict] = None) -> float:
    """Run ``cmd`` on ``world`` ranks, each rank's output in
    ``log_dir/rank<r>.log``.  Returns the wall seconds; raises
    ``RuntimeError`` with the failing ranks' log tails."""
    os.makedirs(log_dir, exist_ok=True)
    port = free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for rank in range(world):
            rank_env = dict(os.environ if env is None else env,
                            MASTER_ADDR="localhost", MASTER_PORT=str(port),
                            RANK=str(rank), WORLD_SIZE=str(world),
                            LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
            logs.append(open(os.path.join(log_dir, f"rank{rank}.log"), "w"))
            procs.append(subprocess.Popen(cmd, env=rank_env, stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        # the first rank that fails ends the spawn: the others would wait
        # for it in a collective until the limit
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes) or any(c for c in codes):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in bad:
            with open(os.path.join(log_dir, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                             + f.read()[-4000:])
        raise RuntimeError(f"{world} ranks: ranks {bad} failed or hung "
                           f"(limit {timeout} s)\n" + "\n".join(tails))
    return wall
