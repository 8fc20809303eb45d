"""Two OS processes of the port in one ``torch.distributed`` world (gloo, CPU).

Each rank joins the world through ``initialize_from_config``, lays a 2×2
global grid over two CPU cells of each rank, and evaluates micro's seven
coalitions sharded over it: both ranks get one process's result within
1e-5, and placed batches without their count raise ``ValueError`` unless
``dataset_size`` is given. The drivers' backend with no ``devices`` named
lays one cell on each rank. A drain seen by rank 1 alone reaches rank 0 through
``_max_across_ranks``. Then both ranks run one ``serve()`` round over a
shared output directory on the same checkpoints: the Shapley values equal
a one-process ``serve()``'s within 1e-5, and only rank 0 writes files.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

from shapley_vit_tpu_torch.driver import serve as tserve
from test_torch_serve_common import port_model, service_cfg, write_epoch
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, port, shared = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

from shapley_vit_tpu_torch.config import DistConfig
from shapley_vit_tpu_torch.driver import serve as serve_mod
from shapley_vit_tpu_torch.fl import checkpoint as ckpt
from shapley_vit_tpu_torch.fl import evaluation as ev
from shapley_vit_tpu_torch.fl import ingestion
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.ops import tree_math as tm
from shapley_vit_tpu_torch.parallel import distributed as pdist
from shapley_vit_tpu_torch.parallel.coalition_eval import (
    make_eval_backend, make_sharded_coalition_evaluator, shard_batches)

assert pdist.initialize_from_config(
    DistConfig(dist_num=2, dist_rank=rank, master_addr="127.0.0.1", master_port=port),
    device="cpu")
info = pdist.process_info(local=["cpu", "cpu"])
assert info["process_count"] == 2 and info["global_devices"] == 4, info

# the sharded evaluation on a 2x2 global grid: this rank owns coalition row `rank`
mesh = pdist.make_global_mesh(DistConfig(dist_num=2), n_coalition=2, local=["cpu", "cpu"])
assert mesh.local_cells() == [(rank, 0), (rank, 1)] and mesh.world == 2
spec = tvit.make_spec("micro")
gen = torch.Generator().manual_seed(0)
base = tvit.init_vit(gen, spec)
lora = tvit.init_lora(gen, spec, classifier_from=base)
deltas = tm.tree_stack([tm.tree_map(lambda a: 0.5 * torch.randn(a.shape, generator=gen), lora)
                        for _ in range(3)])
W = tm.coalition_weight_matrix([[0], [1], [2], [0, 1], [1, 2], [0, 2], [0, 1, 2]],
                               [120, 300, 580], 3)
stacked = tm.materialize_coalitions(lora, deltas, W)
rng = np.random.default_rng(0)
images = rng.normal(size=(13, 16, 16, 3)).astype(np.float32)
labels = rng.integers(0, 4, size=13)
fwd = lambda b, l, x: tvit.vit_forward_coalitions(b, l, x, spec)
got = make_sharded_coalition_evaluator(fwd, mesh)(base, stacked,
                                                  [(images[:8], labels[:8]), (images[8:], labels[8:])])
want = ev.make_coalition_evaluator(fwd)(
    base, stacked, [(torch.tensor(images[:8]), torch.tensor(labels[:8])),
                    (torch.tensor(images[8:]), torch.tensor(labels[8:]))])
np.testing.assert_array_equal(got[:, 0], want[:, 0])
np.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-5, rtol=0)
print("EVAL " + json.dumps(got.tolist()), flush=True)
# placed batches without their recorded count: another rank holds part of
# the weights, so the evaluator asks for dataset_size (JAX's contract)
placed = list(shard_batches(mesh, [(images, labels)]))
try:
    make_sharded_coalition_evaluator(fwd, mesh)(base, stacked, placed)
    raise SystemExit("no ValueError for pre-sharded batches without a count")
except ValueError as e:
    assert "dataset_size" in str(e), e
again = make_sharded_coalition_evaluator(fwd, mesh)(base, stacked, placed, dataset_size=13)
np.testing.assert_allclose(again, got, atol=1e-6, rtol=0)
# the drivers' backend with no devices named: one cell on each rank's own device
default = make_eval_backend(fwd, dist_cfg=DistConfig(), device="cpu")
assert default.mesh.devices.size == 2 and default.mesh.local_cells() in ([(0, rank)], [(rank, 0)])
np.testing.assert_array_equal(
    default.evaluate(base, stacked, [(images[:8], labels[:8]), (images[8:], labels[8:])])[:, 0],
    want[:, 0])

# a drain only rank 1 has seen is every rank's decision
print("MAX " + json.dumps([serve_mod._max_across_ranks(3 if rank == 1 else 0),
                           serve_mod._any_across_ranks(rank == 1),
                           serve_mod._max_across_ranks(float(10 * rank + 0.5))]), flush=True)

# one service round over the shared directory; count every artifact write
writes = {}

def counted(mod, name):
    real = getattr(mod, name)

    def wrapper(*a, **k):
        writes[name] = writes.get(name, 0) + 1
        return real(*a, **k)

    setattr(mod, name, wrapper)

for mod, name in [(serve_mod, "_write_service_state"), (serve_mod, "render_round_report"),
                  (ckpt, "save_pytree"), (ckpt, "save_utility_table"),
                  (ckpt, "append_utility_log"), (ingestion, "save_lora_checkpoint")]:
    counted(mod, name)

sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from test_torch_serve_common import service_cfg
import pathlib

cfg = service_cfg(pathlib.Path(shared), local=pathlib.Path(shared) / "local")
cfg.model.compute_dtype = "float32"
records = serve_mod.serve(cfg, max_rounds=1, timeout=60.0, policy="fail", device="cpu")
assert len(records) == 1
serve_mod.report_mod.flush_async_plots()
print("SERVE_SV " + json.dumps([[r["shapley"][d][c] for c in range(3)] for d in (0, 1)
                                for r in records]), flush=True)
print("ARTIFACTS " + json.dumps(len(records[0]["artifacts"])), flush=True)
print("WRITES " + json.dumps(writes), flush=True)
"""


_TRAIN_CHILD = r"""
import json, sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, port = int(sys.argv[1]), int(sys.argv[2])

from shapley_vit_tpu_torch.config import DistConfig
from shapley_vit_tpu_torch.fl import training as tr
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.ops import tree_math as tm
from shapley_vit_tpu_torch.parallel import distributed as pdist
from shapley_vit_tpu_torch.parallel.client_train import make_sharded_multi_client_train_step

assert pdist.initialize_from_config(
    DistConfig(dist_num=2, dist_rank=rank, master_addr="127.0.0.1", master_port=port),
    device="cpu")
spec = tvit.make_spec("micro", attention_impl="pallas", mlp_impl="xla")
gen = torch.Generator().manual_seed(0)
base = tvit.init_vit(gen, spec)
lora = tvit.init_lora(gen, spec, classifier_from=base)
stacked = tm.tree_stack([tm.tree_map(lambda a: a + 0.05 * torch.randn(a.shape, generator=gen), lora)
                         for _ in range(2)])
rng = np.random.default_rng(0)
images = rng.normal(size=(2, 4, 16, 16, 3)).astype(np.float32)
labels = rng.integers(0, 4, size=(2, 4))
fwd = lambda b, l, x: tvit.vit_forward(b, l, x, spec)

out = {}
# one client per rank under Adam; one client's batch across both ranks
# under SGD with momentum (Adam's first steps, lr * g / (|g| + eps), turn the
# data split's reordered sums of near-cancelling gradients into 2.7e-6 here)
for n_c, opt in ((2, tr.adam(5e-3)), (1, tr.sgd(1e-2, momentum=0.9))):
    one = tr.make_multi_client_train_step(fwd, opt, spec.num_classes)
    want_lora = tr.trainable(stacked)
    state = opt.init(want_lora)
    mesh = pdist.make_global_mesh(DistConfig(dist_num=2), n_coalition=n_c, local=["cpu"])
    step = make_sharded_multi_client_train_step(fwd, opt, spec.num_classes, mesh)
    clients = step.init(stacked)
    err = 0.0
    for _ in range(3):
        want_lora, state, want = one(base, want_lora, state, torch.tensor(images),
                                     torch.tensor(labels))
        clients, got = step(base, clients, images, labels)
        err = max(err, float((got - want).abs().max()))
    for g, w in zip(tm.tree_leaves(clients.stacked()), tm.tree_leaves(want_lora)):
        err = max(err, float((g - w.detach()).abs().max()))
    out[f"{n_c}x{2 // n_c}"] = [mesh.local_cells(), err]
print("TRAIN " + json.dumps(out), flush=True)
"""


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return str(sock.getsockname()[1])


def _run_ranks(child, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", child, str(r), *args], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return outs


def _lines(out, tag):
    return [json.loads(line[len(tag) + 1:]) for line in out.splitlines() if line.startswith(tag + " ")]


def test_two_gloo_ranks_equal_one_process(tmp_path):
    shared = tmp_path / "shared"
    cfg = service_cfg(shared, local=shared / "local")
    cfg.model.compute_dtype = "float32"
    spec, _, lora = port_model(cfg)
    write_epoch(cfg, spec, lora, 0)

    outs = _run_ranks(_CHILD, _free_port(), str(shared))

    evals = [np.array(_lines(out, "EVAL")[0]) for out in outs]
    np.testing.assert_array_equal(evals[0], evals[1])
    assert [_lines(out, "MAX")[0] for out in outs] == [[3, True, 10.5]] * 2

    # the one-process service on the same checkpoints, in its own directory
    one = service_cfg(tmp_path / "one", local=shared / "local")
    one.model.compute_dtype = "float32"
    records = tserve.serve(one, max_rounds=1, timeout=60.0, policy="fail", device="cpu")
    want = np.array([[records[0]["shapley"][d][c] for c in range(3)] for d in (0, 1)])
    assert np.abs(want).max() > 1e-3
    for out in outs:
        np.testing.assert_allclose(np.array(_lines(out, "SERVE_SV")[0]), want, atol=1e-5, rtol=0)

    # rank 0 wrote the round's files; rank 1 wrote none
    writes = [_lines(out, "WRITES")[0] for out in outs]
    assert writes[1] == {} and _lines(outs[1], "ARTIFACTS")[0] == 0
    assert {"_write_service_state", "render_round_report", "save_pytree",
            "save_lora_checkpoint"} <= set(writes[0]) and _lines(outs[0], "ARTIFACTS")[0] > 0
    assert os.path.exists(os.path.join(cfg.paths.global_model_path, "ViT_global_epoch_0.npz"))
    assert tserve.read_service_state(cfg.output_dir)["next_epoch"] == 1


def test_two_gloo_ranks_train_as_one_process():
    outs = _run_ranks(_TRAIN_CHILD, _free_port())
    for rank, out in enumerate(outs):
        got = _lines(out, "TRAIN")[0]
        # one client per rank; then one client's batch across both ranks
        assert got["2x1"][0] == [[rank, 0]] and got["1x2"][0] == [[0, rank]]
        assert got["2x1"][1] <= 1e-6 and got["1x2"][1] <= 1e-6, got
