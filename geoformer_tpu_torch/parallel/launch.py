"""Start the ranks of a data-parallel or data x model run as ``torchrun``
would: one process a rank with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` set, on this host. The layout is the
ranks' own: ``make_mesh(model_parallel=M)`` in each of ``world`` = N x M
ranks makes rank r data index r // M and model index r % M.

    ranks = Ranks([sys.executable, "-m", "geoformer_tpu_torch.cli.train", ...],
                  world=2, timeout_s=600, log_dir="build/ranks")
    ...  # other work meanwhile
    ranks.wait()

Every rank's output goes to a file of its own under ``log_dir``. A rank
that fails, or a run that outlives its timeout, stops every rank and raises
with the tail of each rank's output: a rank that waits in a collective for
a dead peer is not left to hang. ``Ranks`` starts them and returns at once,
so the caller may work meanwhile; its ``wait`` collects them.
"""

from __future__ import annotations

import os
import socket
import subprocess
import time


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int, base: dict | None = None) -> dict:
    env = dict(os.environ if base is None else base)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return env


def _tail(path: str, n: int = 4000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


class Ranks:
    """The processes of ranks 0..world-1 running ``argv``, started at once;
    ``wait`` collects them."""

    def __init__(self, argv: list[str], world: int, timeout_s: float, log_dir: str,
                 env: dict | None = None, cwd: str | None = None):
        port = free_port()
        os.makedirs(log_dir, exist_ok=True)
        self.deadline = time.monotonic() + timeout_s
        self.timeout_s = timeout_s
        self.procs, self.logs = [], []
        try:
            for rank in range(world):
                self.logs.append(os.path.join(log_dir, f"rank{rank}.log"))
                with open(self.logs[-1], "w") as out:
                    self.procs.append(subprocess.Popen(
                        argv, env=rank_env(rank, world, port, base=env), cwd=cwd, stdout=out,
                        stderr=subprocess.STDOUT))
        except BaseException:
            self.stop()
            raise

    def wait(self) -> None:
        """Wait for every rank. Raises RuntimeError, after stopping every
        rank, when one exits non-zero or the ranks outlive the timeout."""
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank(s) {failed} failed (exit codes {codes})")
                if all(c == 0 for c in codes):
                    return
                if time.monotonic() > self.deadline:
                    raise RuntimeError(f"ranks still running after {self.timeout_s} s (exit "
                                       f"codes {codes}): a rank waiting in a collective?")
                time.sleep(0.05)
        except RuntimeError as e:
            self.stop()
            tails = "\n".join(f"--- rank {r} ---\n{_tail(p)}" for r, p in enumerate(self.logs))
            raise RuntimeError(f"{e}\n{tails}") from None
        finally:
            self.stop()

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

