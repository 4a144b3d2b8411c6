"""The port's multi-process exchange (``parallel.distributed.
ProcessGroupExchange``) on two gloo processes of two blocks or parts each:
the ShardedPaddedWave solve, and the ShardedGeneralWave solve in both
assembly modes (``dist.all_gather``; pairwise rounds on
``dist.batch_isend_irecv``), across the process boundary against the same
solve in one process (``halo.LocalExchange``), at 1e-12.

The pattern of ``tests/test_multiprocess.py``: a free port on localhost,
a worker script (``tests/_torch_mp_worker.py``), a time limit per process.
Each worker imports torch and the port only.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import _torch_mp_worker as worker
from wave_fenics_tpu_torch.parallel.sharded_general import ShardedGeneralWave
from wave_fenics_tpu_torch.parallel.sharded_padded import ShardedPaddedWave

TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("parts,mode", [("4,1,1", "stage"), ("2,2,1", "step"),
                                        ("4,1,1", "general-allgather"),
                                        ("4,1,1", "general-ppermute")])
def test_two_process_solve_matches_single_process(tmp_path, parts, mode):
    here = os.path.dirname(os.path.abspath(__file__))
    env = os.environ.copy()
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(here)] + env.get("PYTHONPATH", "").split(os.pathsep)
    ).rstrip(os.pathsep)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(here, "_torch_mp_worker.py"), str(port),
             str(rank), "2", str(tmp_path), parts, mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a worker ran past {TIMEOUT_S} s")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err}"
        assert "done" in out and "backend: gloo" in out

    shape = tuple(int(s) for s in parts.split(","))
    if mode.startswith("general"):
        sw = ShardedGeneralWave(worker.general_model(), shape[0],
                                exchange=mode.split("-")[1])
    else:
        sw = ShardedPaddedWave(worker.model(), shape)
    u_ref, v_ref = worker.solve(sw, mode)
    for name, ref in (("u", u_ref), ("v", v_ref)):
        got = np.load(tmp_path / f"{name}.npy")
        scale = max(np.abs(ref).max(), 1e-300)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * scale)
    assert np.abs(v_ref).max() > 0.0
