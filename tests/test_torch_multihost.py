"""Port parity: the shard mesh (``parallel/mesh.py``) and the two-process
check (``parallel/multihost_check.py``).

Two OS processes, two CPU shards each, joined by ``torch.distributed``
(gloo) through a ``file://`` rendezvous in the test's own directory (no
port: the suite's workers run side by side), run the sharded step on the
reference's ``make_problem``. The cross-process sum adds the two
processes' partial sums where the one-process mesh adds the four shards in
turn, so the bits differ by f32 reduction order, which the system's
conditioning amplifies (at lambda 1e-3 the pose step of every f32 run is
~1e-3 relative from float64; measured: one-process port 8.2e-4, the
reference 3.6e-4, two processes 1.4e-3). So each output of the two
processes is held, relative to its largest magnitude, to the port's
float64 run of the same four shards, to the one-process mesh and to the
JAX package's 4-device run, each within 4x the larger of the one-process
port's and the reference's distances from float64, plus 1e-6 (K15's 3x
rule and one more f32 reduction order). The processes start once for the
module. The mesh's own rules are held exactly: the
placement, shard coordinates, each collective's order and result, and
the bytes it counts.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.parallel import dist_lba as jdist
from plslam_tpu.parallel import multihost_check as jcheck
from plslam_tpu.parallel.mesh import make_mesh as jmake_mesh
from plslam_tpu_torch.parallel import multihost_check as tcheck
from plslam_tpu_torch.parallel.mesh import (Mesh, init_multihost,
                                            make_global_mesh, make_mesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "plslam_tpu_torch.parallel.multihost_check",
         "--rank", str(r), "--nprocs", "2",
         "--init", f"file://{out / 'rendezvous'}", "--out", str(out),
         "--local-shards", "2", "--backend", "gloo", "--device", "cpu"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-3000:]}"
    return np.load(out / "rank0.npz")


def test_make_problem_is_the_references():
    ref = jcheck.make_problem()
    got = tcheck.make_problem_np()
    for f, x in ref._asdict().items():
        assert np.array_equal(np.asarray(x), got[f]), f


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_two_processes_match_one_process_mesh(two_process):
    z = two_process
    assert int(z["n_shards"]) == 4                  # 2 processes x 2 shards
    assert int(z["reduce_bytes"]) == jdist.comm_bytes_per_step(4)
    one = tcheck.dist_step(make_mesh(4, ("lm",), "cpu"), "cpu")
    truth = _f64_step()
    b = jdist.bucket_problem_by_owner(jcheck.make_problem(), 4)
    ref = jdist.make_dist_lba_step(jmake_mesh(4, axes=("lm",)),
                                   _jax_cam())(b.problem, jnp.asarray(1e-3))
    ref = (np.asarray(ref[0]),
           np.asarray(jdist.unbucket_landmarks(ref[1], b.pt_perm)),
           np.asarray(jdist.unbucket_landmarks(ref[2], b.ep_perm)))
    for name, got, o, r, t in zip(("dxi", "d_pt", "d_ep"),
                                  (z["dxi"], z["d_pt"], z["d_ep"]), one, ref,
                                  truth):
        bound = 4 * max(_rel(o, t), _rel(r, t)) + 1e-6
        dists = (_rel(got, t), _rel(got, o), _rel(got, r))
        assert max(dists) <= bound, (name, dists, bound)
    # non-trivial: the step moved the state
    assert float(np.abs(z["dxi"]).max()) > 1e-4
    assert float(np.abs(z["d_pt"]).max()) > 1e-4


def _f64_step():
    """The port's plain versions in float64 on one 4-shard mesh."""
    from plslam_tpu_torch import convert
    from plslam_tpu_torch.parallel import dist_lba as tdist
    tb = tdist.bucket_problem_by_owner(convert.lba_problem_from_numpy(
        tcheck.make_problem_np(), "cpu"), 4)
    p64 = type(tb.problem)(*(x.double() if x.is_floating_point() else x
                             for x in tb.problem))
    dxi, d_pt, d_ep = tdist.make_dist_lba_step(
        make_mesh(4, ("lm",), "cpu"), tcheck.camera(), ops=tdist.PLAIN)(
        p64, 1e-3)
    return (dxi.numpy(), d_pt[tb.pt_perm].numpy(), d_ep[tb.ep_perm].numpy())


def _jax_cam():
    from plslam_tpu.config import CameraConfig
    from plslam_tpu.core.camera import StereoCamera
    return StereoCamera.from_config(CameraConfig(
        width=640, height=480, fx=500.0, fy=500.0, cx=320.0, cy=240.0,
        baseline=0.4))


def test_mesh_placement_and_coordinates():
    m = make_mesh(8, ("kf", "lm"), "cpu")
    assert m.shape == {"kf": 2, "lm": 4} and m.size == 8
    assert m.devices == [torch.device("cpu")] * 8
    assert [m.coords(i) for i in (0, 3, 4, 7)] == [(0, 0), (0, 3), (1, 0),
                                                    (1, 3)]
    assert make_mesh(6, ("lm",), "cpu").shape == {"lm": 6}
    if torch.cuda.is_available():
        cm = make_mesh(4, ("lm",), "cuda")
        n = torch.cuda.device_count()
        assert [d.index for d in cm.devices] == [i % n for i in range(4)]
    else:
        with pytest.raises(RuntimeError):
            make_mesh(4, ("lm",))
    # a process of a 2-process global mesh holds rows [r a, (r + 1) a)
    g = Mesh([torch.device("cpu")] * 2, (1, 2), ("kf", "lm"), rank=1,
             world=2)
    assert g.shape == {"kf": 2, "lm": 2} and g.coords(1) == (1, 1)
    # without a process group the global mesh is the local one
    lone = make_global_mesh(("lm",), n_local=3, device="cpu")
    assert lone.world == 1 and lone.shape == {"lm": 3}


def test_mesh_collectives_order_and_bytes():
    m = make_mesh(8, ("kf", "lm"), "cpu")
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))
          for _ in range(8)]
    s = m.psum(xs, "lm")
    for i in range(8):
        row = (i // 4) * 4
        want = ((xs[row] + xs[row + 1]) + xs[row + 2]) + xs[row + 3]
        assert torch.equal(s[i], want)              # shard order, exactly
    k = m.psum(xs, "kf")
    assert torch.equal(k[1], xs[1] + xs[5]) and torch.equal(k[5], k[1])
    assert torch.equal(m.pmax(xs, "lm")[0], torch.stack(xs[:4]).amax(0))
    assert torch.equal(m.pmin(xs, "kf")[6], torch.minimum(xs[2], xs[6]))
    assert m.reduce_bytes == 4 * 20
    g = m.all_gather(xs, "lm")
    assert torch.equal(g[5], torch.stack(xs[4:]))
    x = torch.arange(24.0).reshape(8, 3)
    parts = m.shard(x, "lm")
    assert torch.equal(parts[6], x[4:6])
    assert torch.equal(m.gather(parts, "lm"), x)
    assert m.map(lambda a, b: a + b, [1] * 8, 2) == [3] * 8


def test_init_multihost_one_process_and_backend_choice():
    assert init_multihost() == 0
    assert init_multihost("file:///nowhere", 1, 0, "nccl") == 0
    with pytest.raises(ValueError):
        init_multihost("file:///nowhere", 2, 0, None)
