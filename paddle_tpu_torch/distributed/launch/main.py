"""The launcher CLI (port of ``paddle_tpu/distributed/launch/main.py``;
reference ``python/paddle/distributed/launch/main.py:23``):

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        train.py [script arguments]

starts ``--nproc_per_node`` processes of the script on this node, one a
rank (one a GPU), each with the env contract that ``init_parallel_env``
reads: ``PADDLE_MASTER`` (host:port of the rendezvous store, which rank 0
hosts), ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_RANK``, ``PADDLE_NNODES``, ``PADDLE_NODE_RANK``,
``PADDLE_JOB_ID``, ``PADDLE_RESTART_GEN``, and torch's ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` beside them.

- ``--master``: the store's host:port; on one node, a free port by
  default (the JAX launcher's fixed default port would collide between
  two jobs on one host). Several nodes need it.
- ``--devices``: the cards the node's ranks see (``CUDA_VISIBLE_DEVICES``);
  rank ``i`` binds card ``i`` of them, modulo their number.
- ``--log_dir``: each rank's output to ``worker.<rank>.log``.
- ``--max_restarts N``: when a rank fails, every rank of the node is
  stopped and the whole set relaunched, up to N times, with
  ``PADDLE_RESTART_GEN`` one higher (``Model.fit`` resumes from its
  snapshot on it); a process group cannot take one new rank back, so the
  set restarts where the JAX launcher restarts one worker.
- A rank that fails with no restart left stops the others, and the
  launcher exits with its code; the launcher exits 0 when every rank did.
- ``--elastic_level >= 1`` (the JAX ``ElasticManager``) is not ported
  (``ROADMAP.md``, queue 7).
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from ..spawn import free_port, rank_env


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="launch a distributed training job",
    )
    p.add_argument("--master", default=None,
                   help="rendezvous store host:port (default: this host, a "
                        "free port)")
    p.add_argument("--nnodes", type=int, default=1, help="number of nodes")
    p.add_argument("--rank", type=int, default=0, help="this node's rank")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes (ranks) on this node, one a GPU")
    p.add_argument("--log_dir", default=None, help="per-rank log directory")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="relaunch the node's ranks up to N times on failure")
    p.add_argument("--devices", default=None,
                   help="visible cards (CUDA_VISIBLE_DEVICES)")
    p.add_argument("--elastic_level", type=int, default=0,
                   help="0: off; >=1: elastic membership (not ported)")
    p.add_argument("--job_id", default="default", help="job id")
    p.add_argument("training_script", help="script to run")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _spawn(args, master: str, local_rank: int, generation: int = 0):
    world = args.nnodes * args.nproc_per_node
    rank = args.rank * args.nproc_per_node + local_rank
    env = dict(os.environ)
    env.update(rank_env(master, rank, local_rank, world, args.nnodes,
                        args.rank))
    env.update(PADDLE_RESTART_GEN=str(generation),
               PADDLE_JOB_ID=str(args.job_id))
    if args.devices:
        env["CUDA_VISIBLE_DEVICES"] = args.devices
    cmd = [sys.executable, args.training_script] + list(
        args.training_script_args)
    stdout = stderr = None
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        logf = open(os.path.join(args.log_dir, f"worker.{rank}.log"), "ab")
        stdout = stderr = logf
    proc = subprocess.Popen(cmd, env=env, stdout=stdout, stderr=stderr)
    if args.log_dir:
        logf.close()  # the child holds its own descriptor
    return proc


def _terminate(procs) -> None:
    for p in procs.values():
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.time() + 10
    for p in procs.values():
        try:
            p.wait(max(deadline - time.time(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(argv=None) -> int:
    args = _parse_args(argv)
    if args.elastic_level > 0:
        raise NotImplementedError(
            "launch --elastic_level >= 1: the elastic manager "
            "(fleet/elastic.py) is not ported yet (ROADMAP.md, queue 7)")
    if args.master is None and args.nnodes > 1:
        raise ValueError("launch: several nodes need --master host:port")
    generation = 0
    restarts = 0

    def start():
        master = args.master or f"127.0.0.1:{free_port()}"
        return {i: _spawn(args, master, i, generation)
                for i in range(args.nproc_per_node)}

    def stop(signum, frame):
        raise SystemExit(128 + signum)

    # a launcher told to stop takes its ranks with it (the finally below)
    previous = signal.signal(signal.SIGTERM, stop)
    procs = start()
    try:
        while True:
            alive = False
            for i, p in list(procs.items()):
                code = p.poll()
                if code is None:
                    alive = True
                elif code != 0:
                    _terminate(procs)
                    if restarts < args.max_restarts:
                        restarts += 1
                        generation += 1
                        print(f"[launch] worker {i} exited {code}; RESTART "
                              f"{restarts}/{args.max_restarts} (gen "
                              f"{generation})", file=sys.stderr, flush=True)
                        procs = start()
                        alive = True
                        break
                    print(f"[launch] worker {i} failed with code {code}; "
                          f"terminating job", file=sys.stderr, flush=True)
                    return code if code > 0 else 1
            if not alive:
                return 0
            time.sleep(0.1)
    except KeyboardInterrupt:
        _terminate(procs)
        return 130
    finally:
        _terminate(procs)
        signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    sys.exit(launch())
