"""The ranks of one process group: joining it, and starting it on this
host with a time limit.

:func:`join_ranks` joins the group a launcher started (torchrun's
``env://``) or adopts one the caller started; the serve and train drivers
share it.  A rank's card is ``cuda:{local_rank % device_count}``; the
backend is ``nccl`` when every rank has a card of its own and ``gloo``
when ranks share one (NCCL refuses two ranks on one card) or run on the
CPU.

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

import dataclasses
import hashlib
import os
import socket
import subprocess
import time
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place among the ranks."""

    rank: int
    world: int
    backend: str            # "" on one rank
    shared_card: bool       # several ranks on one card
    owned: bool             # :func:`join_ranks` started the process group

    def device(self, device: torch.device) -> torch.device:
        """``device``, with a CUDA device that names no index placed on this
        rank's card (made current when there are several ranks)."""
        if device.type == "cuda" and device.index is None:
            local = int(os.environ.get("LOCAL_RANK", self.rank))
            device = torch.device("cuda", local % torch.cuda.device_count())
        if device.type == "cuda" and self.world > 1:
            torch.cuda.set_device(device)  # NCCL talks on the current device
        return device


def join_ranks(device_type: str) -> Ranks:
    """Join the process group (torchrun's ``env://``), or adopt the one the
    caller started; one rank without either."""
    owned = not dist.is_initialized()
    world = (int(os.environ.get("WORLD_SIZE", "1")) if owned
             else dist.get_world_size())
    if world <= 1:
        return Ranks(0, 1, "", False, False)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    shared = device_type == "cuda" and local_world > torch.cuda.device_count()
    if owned:
        dist.init_process_group(
            "nccl" if device_type == "cuda" and not shared else "gloo",
            init_method="env://")
    return Ranks(dist.get_rank(), world, str(dist.get_backend()), shared, owned)


def ranks_agree(ranks: Ranks, text: bytes, device) -> bool:
    """Whether every rank holds the same ``text`` (a digest all-gathered;
    on the card under ``nccl``, on the host under ``gloo``)."""
    digest = int.from_bytes(hashlib.sha256(text).digest()[:7], "little")
    dev = device if ranks.backend == "nccl" else "cpu"
    mine = torch.tensor([digest], dtype=torch.int64, device=dev)
    every = [torch.empty_like(mine) for _ in range(ranks.world)]
    dist.all_gather(every, mine)
    return all(int(t) == digest for t in every)


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
