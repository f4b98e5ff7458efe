"""The port's launcher, ``spawn`` and ``Master`` rendezvous.

- ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2``
  starts two ranks with the env contract ``init_parallel_env`` reads
  (``PADDLE_MASTER``, ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ...);
  it exits 0 when both do, and with a failing rank's code (the other rank
  stopped) when one fails. (The ranks meeting through the store and
  all-reducing is every launched suite of ``torch_dist_cases.py``.)
- ``--max_restarts 1``: a job whose rank fails at generation 0 is started
  again with ``PADDLE_RESTART_GEN=1`` and completes; ``--elastic_level 1``
  raises naming ``ROADMAP.md`` queue 7.
- ``distributed.spawn`` runs a function on 2 ranks.
- ``Master``'s keys under ``rdzv/<job>/`` round-trip as the JAX test
  ``test_elastic_launch.py::test_master_rendezvous_kv`` holds them.

Every launched rank is a gloo process on the CPU; every process a test
starts has ended when it returns.
"""
import os
import textwrap

import pytest

import torch_dist_cases as cases
from paddle_tpu_torch.distributed.launch import main as launch_main
from paddle_tpu_torch.distributed.launch.master import Master
from paddle_tpu_torch.distributed.spawn import free_port, spawn

# a rank that records its env contract and fails at the generations below
# FAIL_GENS; the ranks meeting through the store is what every launched
# suite of tests/torch_dist_cases.py does (and test_spawn_... here)
WORKER = textwrap.dedent("""
    import json, os, sys
    out, rank = sys.argv[1], os.environ["PADDLE_TRAINER_ID"]
    gen = int(os.environ["PADDLE_RESTART_GEN"])
    keys = ("PADDLE_MASTER", "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
            "PADDLE_LOCAL_RANK", "PADDLE_RESTART_GEN", "PADDLE_JOB_ID",
            "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    with open(os.path.join(out, f"rank{rank}.gen{gen}.json"), "w") as f:
        json.dump({k: os.environ[k] for k in keys}, f)
    if rank == os.environ.get("FAIL_RANK") and gen < int(
            os.environ.get("FAIL_GENS", "0")):
        # the launcher stops the other ranks when this one fails: wait
        # (up to a minute) until they have recorded theirs
        import time
        n = int(os.environ["PADDLE_TRAINERS_NUM"])
        deadline = time.time() + 60
        while time.time() < deadline and not all(os.path.exists(
                os.path.join(out, f"rank{r}.gen{gen}.json"))
                for r in range(n)):
            time.sleep(0.05)
        sys.exit(3)
""")


# a rank that only exits: 3 on rank 1, 0 on the others
EXITS = textwrap.dedent("""
    import os, sys
    sys.exit(3 if os.environ["PADDLE_TRAINER_ID"] == "1" else 0)
""")


def _launch(tmp_path, monkeypatch, *args, env=None, text=WORKER):
    """The launcher's ``launch`` called in this process (its ranks are
    processes of their own), with ``env`` added to theirs."""
    script = tmp_path / "worker.py"
    script.write_text(text)
    monkeypatch.setenv("PYTHONPATH", cases.REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for key, value in (env or {}).items():
        monkeypatch.setenv(key, value)
    return launch_main.launch(["--nproc_per_node", "2", *args, str(script),
                               str(tmp_path)])


def _seen(tmp_path, rank, gen):
    import json

    with open(tmp_path / f"rank{rank}.gen{gen}.json") as f:
        return json.load(f)


def test_two_ranks_get_the_env_contract_and_a_restart_the_next_generation(
        tmp_path, monkeypatch, capfd):
    """Rank 0 fails at generation 0; the launcher stops rank 1, starts
    both again with ``PADDLE_RESTART_GEN=1`` on a new store port, and they
    exit 0."""
    code = _launch(tmp_path, monkeypatch, "--max_restarts", "1", "--job_id",
                   "two", "--log_dir", str(tmp_path / "logs"),
                   env={"FAIL_RANK": "0", "FAIL_GENS": "1"})
    err = capfd.readouterr().err
    assert code == 0, err[-3000:]
    assert "worker 0 exited 3; RESTART 1/1 (gen 1)" in err
    for gen in (0, 1):
        masters = set()
        for r in range(2):
            env = _seen(tmp_path, r, gen)
            assert env["PADDLE_TRAINER_ID"] == env["RANK"] == str(r)
            assert env["PADDLE_LOCAL_RANK"] == str(r)
            assert env["PADDLE_TRAINERS_NUM"] == env["WORLD_SIZE"] == "2"
            assert env["PADDLE_JOB_ID"] == "two"
            assert env["PADDLE_RESTART_GEN"] == str(gen)
            host, port = env["PADDLE_MASTER"].rsplit(":", 1)
            assert (host, port) == (env["MASTER_ADDR"], env["MASTER_PORT"])
            masters.add(env["PADDLE_MASTER"])
        assert len(masters) == 1
    assert sorted(os.listdir(tmp_path / "logs")) == ["worker.0.log",
                                                     "worker.1.log"]


def test_a_failing_rank_fails_the_launcher_with_its_code(tmp_path,
                                                        monkeypatch, capfd):
    assert _launch(tmp_path, monkeypatch, text=EXITS) == 3
    assert "worker 1 failed with code 3" in capfd.readouterr().err
    assert _launch(tmp_path, monkeypatch, "--nproc_per_node", "1",
                   text=EXITS) == 0


def test_elastic_level_raises_naming_queue_7(tmp_path):
    with pytest.raises(NotImplementedError, match="queue 7"):
        launch_main.launch(["--elastic_level", "1", str(tmp_path / "x.py")])
    with pytest.raises(ValueError, match="--master"):
        launch_main.launch(["--nnodes", "2", str(tmp_path / "x.py")])


def test_spawn_runs_a_function_on_two_ranks(tmp_path):
    spawn(cases.spawned_sum, args=(str(tmp_path),), nprocs=2)
    for r in range(2):
        text = (tmp_path / f"spawn{r}.txt").read_text().split()
        assert text == [str(r), "2", "3.0", "2"]


def test_master_rendezvous_kv():
    """The counterpart of ``test_elastic_launch.py::
    test_master_rendezvous_kv``: register, ``sync_peers``, the generation
    and user keys, in one process (the store's host and its client)."""
    m = Master(f"127.0.0.1:{free_port()}", rank=0, nnodes=1,
               job_id="kvt")
    m.register("127.0.0.1:9999", nproc=2)
    peers = m.sync_peers(timeout=10.0)
    assert peers == [{"endpoint": "127.0.0.1:9999", "nproc": 2, "rank": 0}]
    g0 = m.generation()
    assert m.bump_generation() == g0 + 1
    assert m.wait_generation(g0, timeout=1.0) == g0 + 1
    m.set("custom", "abc")
    assert m.get("custom", timeout=5.0) == b"abc"
    assert m.add("counter", 2) == 2
    assert m.store.get("rdzv/kvt/peers/0")
    assert m.store.add("rdzv/kvt/joined", 0) == 1
    m.close()
