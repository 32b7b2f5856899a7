"""One rank of a gloo world of tests/test_torch_parallel.py.

    RANK=r WORLD_SIZE=n MASTER_PORT=p python _torch_parallel_worker.py INPUTS.npz OUT_DIR

Imports torch and the port only (never jax), runs every check of its
world in one start-up on the CPU and writes what each rank computed to
OUT_DIR/rank<r>.npz; the test process holds it against the JAX package.
World 4 is a (host, chip) mesh of 2 x 2 (LOCAL_WORLD_SIZE=2 in the
environment makes two "hosts"); world 8 is 1-D, with a 2 x 4 host mesh
beside it for the block layout.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from opencv_tpu_torch import convert
from opencv_tpu_torch.core.config import MatchConfig
from opencv_tpu_torch.ops import matching
from opencv_tpu_torch.optim import ba
from opencv_tpu_torch.parallel import dist_ba, dist_match, mesh, multihost

HC = (multihost.HOST_AXIS, multihost.CHIP_AXIS)


def _problem(x):
    return convert.ba_problem({f: x["ba_" + f] for f in ba.BAProblem._fields if "ba_" + f in x}, device="cpu")


def _solved(prefix, out):
    opt, cost = out
    return {f"{prefix}_rvec": opt.cam_rvec.numpy(), f"{prefix}_tvec": opt.cam_tvec.numpy(),
            f"{prefix}_points": opt.points.numpy(), f"{prefix}_cost": cost.numpy()}


def _matches(prefix, m):
    return {f"{prefix}_valid": m.valid.numpy(), f"{prefix}_idx": m.train_idx.numpy(),
            f"{prefix}_dist": m.distance.numpy()}


def _desc(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def world4(x):
    host = multihost.make_host_mesh(device="cpu")
    sim = multihost.simulate_host_mesh(2, device="cpu")
    res = {"host_mesh": host.mesh.numpy(), "sim_mesh": sim.mesh.numpy()}
    res.update(_solved("hc", dist_ba.bundle_adjust_sharded(_problem(x), host, iters=10,
                                                           cg_iters=int(x["ba_cg_iters"]), axes=HC)))
    return res


def world8(x, rank):
    data = mesh.make_mesh(device="cpu")
    res = {"data_mesh": data.mesh.numpy(),
           "two_axis_shape": np.array(mesh.make_mesh(8, (mesh.DATA_AXIS, mesh.MODEL_AXIS),
                                                      device="cpu").mesh.shape)}
    p = _problem(x)
    eqs = dist_ba.sharded_normal_equations(p, data)
    res.update(U=eqs.U.numpy(), V=eqs.V.numpy(), bc=eqs.bc.numpy(), bp=eqs.bp.numpy(),
               A=eqs.A.numpy())
    res.update(_solved("d", dist_ba.bundle_adjust_sharded(p, data, iters=10,
                                                          cg_iters=int(x["ba_cg_iters"]))))

    model = mesh.make_mesh(8, (mesh.MODEL_AXIS,), device="cpu")
    q, t, tv = _desc(x["knn_query"]), _desc(x["knn_train"]), torch.from_numpy(x["knn_tvalid"])
    for cc in (False, True):
        m = dist_match.sharded_knn_match(q, t, model, train_valid=tv,
                                         config=MatchConfig(cross_check=cc))
        res.update(_matches(f"dense{int(cc)}", m))
    q5, t5 = _desc(x["knn_query512"]), _desc(x["knn_train512"])
    qv5, tv5 = torch.from_numpy(x["knn_qvalid512"]), torch.from_numpy(x["knn_tvalid512"])
    cfg5 = MatchConfig(cross_check=False, max_distance=512.0)
    res.update(_matches("dense512", dist_match.sharded_knn_match(q5, t5, model, qv5, tv5, cfg5)))
    # the K3 route (its plain version on the CPU): blocks at the streaming threshold
    matching.STREAMING_TRAIN_THRESHOLD = t.shape[0] // 8
    res.update(_matches("k3", dist_match.sharded_knn_match(q, t, model, train_valid=tv,
                                                           config=MatchConfig(cross_check=False))))
    res.update(_matches("k3_512", dist_match.sharded_knn_match(q5, t5, model, qv5, tv5, cfg5)))
    matching.STREAMING_TRAIN_THRESHOLD = 1 << 62
    cfg_t = MatchConfig(ratio=1.01, max_distance=256.0, cross_check=True)
    res.update(_matches("ties", dist_match.sharded_knn_match(
        _desc(x["tie_query"]), _desc(x["tie_train"]), model, config=cfg_t)))

    hosts = multihost.simulate_host_mesh(2, device="cpu")
    value = x["block_value"]
    for name, axes in (("hc", HC), ("host", multihost.HOST_AXIS), ("chip", multihost.CHIP_AXIS),
                       ("rep", None)):
        res[f"block_{name}"] = multihost.global_sharded(hosts, axes, value, device="cpu").numpy()
    res["block_replicated"] = multihost.fetch_replicated(
        multihost.replicated(hosts, value, device="cpu"))
    res["host0"] = multihost.run_on_host0(lambda: np.arange(4) * 7.0 + rank, (4,), np.float32,
                                          device="cpu")
    return res


def main():
    inputs, out_dir = sys.argv[1], sys.argv[2]
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    torch.set_num_threads(1)
    addr = f"localhost:{os.environ['MASTER_PORT']}"
    multihost.initialize(addr, world, rank, backend="gloo")
    multihost.initialize(addr, world, rank, backend="gloo")  # idempotent: a no-op now
    x = np.load(inputs)
    try:
        res = world4(x) if world == 4 else world8(x, rank)
        res["world"] = np.array(dist.get_world_size())
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


if __name__ == "__main__":
    main()
