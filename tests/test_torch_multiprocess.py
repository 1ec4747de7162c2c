"""The port's row-partitioned path across processes: 2 gloo processes x 4
shards against 1 process x 8 shards (tests/torch_mp_worker.py in both).

The worker runs golden config7's halo V-cycles through the port's runner,
each exchange mode of the halo operators and the halo stencil, and the
sharded AMS-PCG; the exchange and the coarse solve move values without
arithmetic, so the 2-process V-cycle run equals the 1-process one to 1e-14
(its norms are all-reduced in another order), and the PCG, whose dots are
all-reduced too, to 1e-10. The grid-parallel async solves gather the
shards' partials and sum them in shard order in every process, so 2
processes x 4 shards equal 1 x 8 bit for bit. Spawns real processes (one
round of each, shared by the tests): the collectives cross process
memory."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_round(nproc: int):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, WORKER, str(pid), str(nproc), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True)
             for pid in range(nproc)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    return procs, outs


def _results(nproc: int):
    procs, outs = _spawn_round(nproc)
    if any(p.returncode != 0 for p in procs):
        # one retry: the process group's rendezvous can time out on a loaded
        # host
        procs, outs = _spawn_round(nproc)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, f"no RESULT line:\n{out[-2000:]}"
        results.append(json.loads(lines[0][len("RESULT "):]))
    return sorted(results, key=lambda r: r["pid"])


@pytest.fixture(scope="module")
def rounds():
    (one,) = _results(1)
    return one, _results(2)


def test_two_processes_equal_one(rounds):
    one, two = rounds
    with open(os.path.join(REPO, "tests", "golden", "config7_halo_dist_mult.json")) as f:
        g = json.load(f)
    assert one["cycles"] == g["cycles"] and one["level_n"] == g["level_n"]
    for r in two:
        assert r["cycles"] == one["cycles"] and r["level_n"] == one["level_n"]
        np.testing.assert_allclose(r["history"], one["history"], rtol=1e-14, atol=0)
        np.testing.assert_allclose(r["x"], one["x"], rtol=0,
                                   atol=1e-14 * np.abs(one["x"]).max())
        for mode, y in one["y"].items():
            np.testing.assert_allclose(r["y"][mode], y, rtol=0,
                                       atol=1e-14 * np.abs(y).max(), err_msg=mode)
        assert r["ams_iters"] == one["ams_iters"]
        np.testing.assert_allclose(r["ams_x"], one["ams_x"], rtol=0,
                                   atol=1e-10 * np.abs(one["ams_x"]).max())


def test_the_grid_solve_on_two_processes_equals_one(rounds):
    one, two = rounds
    assert one["grid"]["views"] == list(range(8))
    assert [r["grid"]["views"] for r in two] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    for name in ("semi", "full coalesced local"):
        want = one["grid"][name]
        assert want["history"][-1] <= 2e-8
        for r in two:
            assert r["grid"][name] == want, name
