"""The port's ``parallel`` package against ``shapley_vit_tpu.parallel``.

On the CPU, on the suite's 8 virtual JAX devices and on grids of the one
torch CPU device (a device may repeat in a port mesh):

* ``make_mesh``'s shapes and errors, and the placement helpers;
* ``choose_coalition_shards`` returns JAX's choice and rationale over a
  sweep of devices, coalitions, batch and memory budgets (zero and negative
  included), and ``coalition_residency_bytes`` JAX's byte counts;
* the sharded evaluator at micro (depth 2) against JAX's
  ``make_sharded_coalition_evaluator`` on the same numpy weights, over 2×4,
  1×8, 4×2 and 8×1 grids: C = 7 (not a multiple of the coalition axis), a
  remainder batch, chunks that are not axis multiples, merged and overlay
  modes, int8. Correct counts are identical (so are the accuracies),
  losses agree within 1e-5 (int8: 1e-4, the bar of the two packages' int8
  logits; against the port's single-device evaluator 1e-5) and the padded
  rows are dropped;
* ``make_eval_backend``'s gate, and ``start()`` over a forced 2×2 grid
  against the single-device ``start()`` (Shapley values within 1e-4).

The tests marked ``cuda`` hold the sharded evaluator, and the sharded
multi-client training step, on ``cuda:0`` grids against their
single-device counterparts on the card; they import no JAX:

    python -m pytest --noconftest -q tests/test_torch_parallel.py -m cuda
"""

import numpy as np
import pytest
import torch

from shapley_vit_tpu_torch.config import DistConfig
from shapley_vit_tpu_torch.data.arrays import ArrayDataset
from shapley_vit_tpu_torch.fl import evaluation as tev
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.ops import tree_math as ttm
from shapley_vit_tpu_torch.parallel import autoshape as tauto
from shapley_vit_tpu_torch.parallel import distributed as pdist
from shapley_vit_tpu_torch.parallel import mesh as tmesh
from shapley_vit_tpu_torch.parallel.coalition_eval import (
    ShardedBatch,
    make_eval_backend,
    make_sharded_coalition_evaluator,
    shard_batches,
)
from torch_one_thread import one_torch_thread  # noqa: F401

COALITIONS = [[0], [1], [2], [0, 1], [1, 2], [0, 2], [0, 1, 2]]  # C = 7
SIZES = [120, 300, 580]


def _cpu_grid(n_c, n_d):
    return tmesh.make_mesh(n_c, n_d, ["cpu"] * (n_c * n_d))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_make_mesh_shapes():
    mesh = tmesh.make_mesh(n_coalition=2, devices=["cpu"] * 8)
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ("coalition", "data")
    assert mesh.shape == {"coalition": 2, "data": 4}
    mesh1 = tmesh.make_mesh(n_coalition=1, n_data=1, devices=["cpu"])
    assert mesh1.devices.shape == (1, 1)
    with pytest.raises(ValueError):
        tmesh.make_mesh(n_coalition=3, devices=["cpu"] * 8)  # 8 % 3 != 0
    with pytest.raises(ValueError):
        tmesh.make_mesh(n_coalition=2, n_data=4, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no devices"):
            tmesh.make_mesh()  # the default: every CUDA device


def test_placement_helpers_split_and_replicate_once_per_device():
    mesh = _cpu_grid(2, 2)
    x = torch.arange(8.0)
    coal = tmesh.put_coalition_stacked(mesh, {"w": x})
    assert [coal[c]["w"].tolist() for c in [(0, 0), (0, 1), (1, 0), (1, 1)]] == [
        [0, 1, 2, 3], [0, 1, 2, 3], [4, 5, 6, 7], [4, 5, 6, 7]]
    images, labels = tmesh.put_batch(mesh, np.arange(4.0), np.arange(4))
    assert images[(1, 0)].tolist() == [0, 1] and labels[(0, 1)].tolist() == [2, 3]
    rep = tmesh.put_replicated(mesh, {"w": x})
    # one copy per distinct device: every cell of a one-device grid shares it
    assert len({id(t["w"]) for t in rep.values()}) == 1 and rep[(1, 1)]["w"] is x
    with pytest.raises(ValueError, match="does not split"):
        tmesh.put_coalition_stacked(mesh, {"w": torch.arange(3.0)})


# ---------------------------------------------------------------------------
# autoshape
# ---------------------------------------------------------------------------

def _fields(c):
    return (c.n_coalition, c.n_data, c.padded_work, c.batch_per_device,
            c.coalitions_per_device, c.resident_bytes, c.rationale)


@pytest.mark.parametrize("n_devices", range(1, 9))
def test_choose_coalition_shards_matches_jax(n_devices):
    from shapley_vit_tpu.parallel import autoshape as jauto

    budgets = [(0, 0, 0), (28_000_000, 16_000_000_000, 344_000_000),
               (28_000_000, 100_000_000, 0), (28_000_000, 0, 0),
               (8, 1_000, 1_000),        # zero budget: nothing fits
               (8, 1_000, 5_000),        # negative budget
               (10**9, 4 * 10**9, 10**9)]
    for coalitions in (0, 1, 3, 7, 8, 12, 15, 31, 127):
        for batch in (0, 1, 5, 16, 128, 130):
            for cb, hbm, mb in budgets:
                args = (n_devices, coalitions, batch)
                kw = dict(coalition_bytes=cb, hbm_bytes=hbm, model_bytes=mb)
                want = jauto.choose_coalition_shards(*args, **kw)
                assert _fields(tauto.choose_coalition_shards(*args, **kw)) == _fields(want)
        assert tauto.powerset_dominant_coalitions(n_devices, coalitions) == \
            jauto.powerset_dominant_coalitions(n_devices, coalitions)


def test_autoshape_zero_or_negative_budget_still_filters():
    """JAX's ``test_autoshape_zero_or_negative_budget_still_filters`` on the
    port: memory at or under the model's bytes leaves NO coalition budget,
    so every split is infeasible (a warning), and a negative budget names
    the model and memory figures, not a negative GB budget."""
    c = tauto.choose_coalition_shards(
        8, 12, 128, coalition_bytes=1_000_000,
        hbm_bytes=1_000_000_000, model_bytes=1_000_000_000,
    )
    assert "WARNING" in c.rationale and "no coalition budget" in c.rationale
    c = tauto.choose_coalition_shards(
        8, 12, 128, coalition_bytes=1_000_000,
        hbm_bytes=1_000_000_000, model_bytes=2_000_000_000,
    )
    assert "no coalition budget" in c.rationale
    assert "-" not in c.rationale.split("WARNING")[1].split("GB")[0]
    ok = tauto.choose_coalition_shards(8, 8, 128, coalition_bytes=1, hbm_bytes=10**6)
    assert "within budget" in ok.rationale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["overlay", "merged"])
def test_coalition_residency_bytes_matches_jax(mode, dtype):
    import jax
    from shapley_vit_tpu.models import vit as jvit
    from shapley_vit_tpu.parallel import autoshape as jauto

    spec_j, spec_t = jvit.make_spec("micro", dtype=dtype), tvit.make_spec("micro", dtype=dtype)
    base = jax.device_get(jvit.init_vit(jax.random.key(0), spec_j))
    lora = jax.device_get(jvit.init_lora(jax.random.key(1), spec_j, classifier_from=base))
    want = jauto.coalition_residency_bytes(lora, eval_mode=mode, spec=spec_j)
    got = tauto.coalition_residency_bytes(tree_from_numpy(lora), eval_mode=mode, spec=spec_t)
    assert got == want > 0
    assert tauto.coalition_residency_bytes(tree_from_numpy(base)) == \
        jauto.coalition_residency_bytes(base)
    assert tauto.coalition_residency_bytes(None) is None
    with pytest.raises(ValueError, match="spec"):
        tauto.coalition_residency_bytes(lora, eval_mode="merged")


# ---------------------------------------------------------------------------
# the sharded evaluator against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def micro():
    """Micro weights (JAX's init, as numpy), three clients' deltas, 13
    images in a batch of 8 and a remainder of 5."""
    import jax
    from shapley_vit_tpu.models import vit as jvit

    spec = jvit.make_spec("micro")
    base = jax.device_get(jvit.init_vit(jax.random.key(0), spec))
    lora = jax.device_get(jvit.init_lora(jax.random.key(1), spec, classifier_from=base))
    rng = np.random.default_rng(0)
    # deltas large enough that the coalitions' accuracies differ
    deltas = [jax.tree.map(lambda a: 0.5 * rng.normal(size=a.shape).astype(np.float32), lora)
              for _ in range(3)]
    images = rng.normal(size=(13, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 4, size=13).astype(np.int32)
    batches = [(images[:8], labels[:8]), (images[8:], labels[8:])]
    return dict(base=base, lora=lora, deltas=deltas, batches=batches)


def _port_stack(micro, spec_t, mode):
    """The port's (forward, base, varying stack) for the 7 coalitions."""
    from shapley_vit_tpu_torch.ops import tree_math

    W = tree_math.coalition_weight_matrix(COALITIONS, SIZES, 3)
    base = tree_from_numpy(micro["base"])
    stacked = ttm.materialize_coalitions(
        tree_from_numpy(micro["lora"]), tree_from_numpy(ttm.tree_stack_host(micro["deltas"])), W)
    if mode == "merged":
        return (lambda b, m, x: tvit.vit_forward_merged(b, m, x, spec_t), base,
                tvit.merge_coalition_weights(base, stacked, spec_t))
    return lambda b, l, x: tvit.vit_forward_coalitions(b, l, x, spec_t), base, stacked


# (grid, eval mode, quant, coalition chunk): every grid sees C = 7 and the
# remainder batch; chunk 3 on a 2- or 4-wide axis and 5 on a 4-wide axis
# are not axis multiples
CASES = [
    ((2, 4), "overlay", "none", 0),
    ((2, 4), "merged", "int8", 3),
    ((1, 8), "merged", "none", 3),
    ((4, 2), "overlay", "none", 5),
    ((4, 2), "merged", "none", 3),
    ((8, 1), "merged", "none", 0),
    ((8, 1), "overlay", "int8", 0),
]


@pytest.mark.parametrize("grid,mode,quant,chunk", CASES,
                         ids=[f"{g[0]}x{g[1]}-{m}-{q}-chunk{c}" for g, m, q, c in CASES])
def test_sharded_evaluator_matches_jax(micro, grid, mode, quant, chunk):
    import jax
    from shapley_vit_tpu.models import vit as jvit
    from shapley_vit_tpu.ops import tree_math as jtm
    from shapley_vit_tpu.parallel import mesh as jmesh
    from shapley_vit_tpu.parallel.coalition_eval import (
        make_sharded_coalition_evaluator as j_sharded,
    )

    quant_kw = dict(quant="int8", quant_targets=jvit.INT8_TARGETS, mlp_impl="xla") \
        if quant == "int8" else {}
    spec_j, spec_t = jvit.make_spec("micro", **quant_kw), tvit.make_spec("micro", **quant_kw)
    W = jtm.coalition_weight_matrix(COALITIONS, SIZES, 3)
    stacked_j = jtm.materialize_coalitions(micro["lora"], jtm.tree_stack(micro["deltas"]), W)
    if mode == "merged":
        fwd_j = lambda b, m, x: jvit.vit_forward_merged(b, m, x, spec_j)  # noqa: E731
        stacked_j = jvit.merge_coalition_weights(micro["base"], stacked_j, spec_j)
    else:
        fwd_j = lambda b, l, x: jvit.vit_forward(b, l, x, spec_j)  # noqa: E731
    want = j_sharded(fwd_j, jmesh.make_mesh(*grid, devices=jax.devices()),
                     coalition_chunk=chunk)(micro["base"], stacked_j, micro["batches"])

    fwd_t, base_t, stacked_t = _port_stack(micro, spec_t, mode)
    evaluate = make_sharded_coalition_evaluator(fwd_t, _cpu_grid(*grid), coalition_chunk=chunk)
    got = evaluate(base_t, stacked_t, micro["batches"])
    assert got.shape == (7, 2)  # the padded coalition rows are dropped
    assert len(set(got[:, 0].tolist())) > 1
    # identical correct counts: the accuracies are the same float
    np.testing.assert_array_equal(got[:, 0] * 13, np.asarray(want)[:, 0] * 13)
    # int8: the two packages' int8 logits agree within 1e-4
    # (tests/test_torch_quant.py), so their mean losses within that too
    np.testing.assert_allclose(got[:, 1], np.asarray(want)[:, 1],
                               atol=1e-4 if quant == "int8" else 1e-5, rtol=0)
    # and within 1e-5 of the port's own single-device evaluator
    single = tev.make_coalition_evaluator(fwd_t)(
        base_t, stacked_t, [(torch.as_tensor(x), torch.as_tensor(y)) for x, y in micro["batches"]])
    np.testing.assert_array_equal(got[:, 0], single[:, 0])
    np.testing.assert_allclose(got[:, 1], single[:, 1], atol=1e-5, rtol=0)


def test_shard_batches_reuse_and_nan_guard(micro):
    """``shard_batches`` pads the remainder batch with zero-weighted rows and
    records the real-example count; the evaluator reuses the placed batches
    as they are, and a NaN loss names its coalitions."""
    spec_t = tvit.make_spec("micro")
    fwd, base, stacked = _port_stack(micro, spec_t, "merged")
    mesh = _cpu_grid(2, 4)
    placed = shard_batches(mesh, micro["batches"])
    assert placed.real_examples == 13.0 and all(isinstance(b, ShardedBatch) for b in placed)
    # 5 examples pad to 8 over 4 data shards of 2: zero weights on the pad
    assert [placed[1][2][(0, d)].tolist() for d in range(4)] == [
        [1.0, 1.0], [1.0, 1.0], [1.0, 0.0], [0.0, 0.0]]
    evaluate = make_sharded_coalition_evaluator(fwd, mesh)
    got = evaluate(base, stacked, placed)
    np.testing.assert_array_equal(got, evaluate(base, stacked, micro["batches"]))
    # placed batches without the recorded count: counted from the weights
    np.testing.assert_array_equal(got, evaluate(base, stacked, list(placed)))
    bad = dict(stacked, classifier={"kernel": stacked["classifier"]["kernel"].clone(),
                                    "bias": stacked["classifier"]["bias"].clone()})
    bad["classifier"]["bias"][4] = float("nan")
    with pytest.raises(FloatingPointError, match=r"coalitions \[4\]"):
        evaluate(base, bad, placed)


# ---------------------------------------------------------------------------
# the drivers' gate
# ---------------------------------------------------------------------------

def test_make_eval_backend_gate(micro):
    spec_t = tvit.make_spec("micro")
    fwd, base, stacked = _port_stack(micro, spec_t, "merged")
    batches = [(torch.as_tensor(x), torch.as_tensor(y).long()) for x, y in micro["batches"]]
    today = tev.make_coalition_evaluator(fwd, coalition_chunk=3)(base, stacked, batches)

    def backend(devices, **dist):
        return make_eval_backend(fwd, coalition_chunk=3, dist_cfg=DistConfig(**dist),
                                 devices=devices, device="cpu", typical_coalitions=7,
                                 eval_batch=8)

    # "auto" on one device, and "off" anywhere: a 1x1 mesh, bit-identical to
    # the single-device evaluator the drivers used before the mesh
    for b in (backend(["cpu"]), backend(["cpu"], mesh_coalition_shards=2),
              backend(["cpu"] * 4, mesh="off"),
              backend(["cpu"] * 4, mesh="off", mesh_coalition_shards=2)):
        assert b.mesh.shape == {"coalition": 1, "data": 1}
        np.testing.assert_array_equal(b.evaluate(base, stacked, batches), today)
        data = b.device_batches(ArrayDataset(np.concatenate([x for x, _ in micro["batches"]]),
                                             np.concatenate([y for _, y in micro["batches"]])), 8)
        np.testing.assert_array_equal(b.evaluate(base, stacked, data), today)
    # more than one device (repeats count, as in JAX) shards; the operator's
    # coalition-axis size overrides
    logs = []
    b = make_eval_backend(fwd, coalition_chunk=3, devices=["cpu"] * 4, device="cpu",
                          dist_cfg=DistConfig(mesh_coalition_shards=2), log_fn=logs.append)
    assert b.mesh.shape == {"coalition": 2, "data": 2}
    assert "mesh 2x2" in logs[0] and "operator override" in logs[0]
    got = b.evaluate(base, stacked, batches)
    np.testing.assert_array_equal(got[:, 0], today[:, 0])
    np.testing.assert_allclose(got[:, 1], today[:, 1], atol=1e-5, rtol=0)
    # without an override the workload hints pick the split (autoshape)
    auto = backend(["cpu"] * 4)
    want = tauto.choose_coalition_shards(4, 7, 8)
    assert auto.mesh.shape["coalition"] == want.n_coalition
    with pytest.raises(ValueError, match="does not divide"):
        backend(["cpu"] * 4, mesh_coalition_shards=3)
    for mode in ("sometimes", "on"):
        with pytest.raises(ValueError, match="dist.mesh"):
            backend(["cpu"], mesh=mode)


def test_default_devices_are_the_rank_card_in_a_world(monkeypatch):
    """With no ``devices``, one process takes every visible card, and a rank
    of a world of several takes only its current card (NCCL refuses two
    ranks on one GPU); the CPU is the CPU either way."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert pdist.default_local_devices("cuda") == [torch.device("cuda", i) for i in range(4)]
    assert pdist.default_local_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(pdist, "world_size", lambda: 2)
    assert pdist.default_local_devices("cuda") == [torch.device("cuda", 2)]
    assert pdist.default_local_devices("cpu") == [torch.device("cpu")]


def test_start_over_a_2x2_grid_matches_one_device(tmp_path):
    """``start()`` on micro with the mesh forced over a 2×2 CPU grid: the
    same Shapley values as the single-device ``start()`` within 1e-4."""
    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.driver import start as tstart
    from shapley_vit_tpu_torch.fl import ingestion
    from shapley_vit_tpu_torch.models.convert import tree_to_numpy

    def cfg_for(out):
        cfg = Config()
        cfg.model.vit_variant = "micro"
        cfg.model.compute_dtype = "float32"
        cfg.data.synthetic_scale = 0.1   # 40 validation images
        cfg.data.eval_batch_size = 16
        cfg.obs.exp_dir = str(tmp_path / out)
        return cfg

    cfg = cfg_for("single")
    spec, _, lora = tstart.build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate(SIZES):
        drop = ttm.tree_map(lambda a: a + 0.5 * rng.normal(size=a.shape).astype(np.float32),
                            tree_to_numpy(lora))
        p = str(tmp_path / f"client_{i + 1}_model" / "ViT_epoch_9.npz")
        ingestion.save_lora_checkpoint(p, drop, spec, num_local_data_train=n)
        paths.append(p)
    one, _ = tstart.start(cfg, checkpoint_paths=paths, device="cpu")
    cfg = cfg_for("mesh")
    cfg.dist.mesh, cfg.dist.mesh_coalition_shards = "auto", 2
    grid, _ = tstart.start(cfg, checkpoint_paths=paths, device="cpu", devices=["cpu"] * 4)
    sv = lambda r: np.array([[r[d][k][c] for c in range(3)] for d in (0, 1) for k in (0, 1)])  # noqa: E731
    assert np.abs(sv(one)).max() > 1e-3
    np.testing.assert_allclose(sv(grid), sv(one), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the forward's kernels are CUDA C++ for sm_90a)")


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_evaluator_on_cuda_grids(grid, dtype):
    """The sharded evaluator on a grid of ``cuda:0`` (repeated for 2×2)
    against the single-device evaluator on the card, through the patch,
    packed-attention and MLP kernels of every cell: identical correct
    counts, losses within 1e-5 relative."""
    _card()
    from shapley_vit_tpu_torch.ops.attention import fused_attention_packed
    from shapley_vit_tpu_torch.ops.mlp_block import fused_mlp_block
    from shapley_vit_tpu_torch.ops.patch_embed import patch_embed

    spec = tvit.make_spec("tiny", dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    base = tvit.init_vit(gen, spec, device="cuda")
    lora = tvit.init_lora(gen, spec, classifier_from=base, device="cuda")
    stacked = ttm.tree_stack([ttm.tree_map(lambda a: a + 0.05 * torch.randn(
        a.shape, generator=gen).to("cuda"), lora) for _ in range(7)])
    rng = np.random.default_rng(0)
    images = rng.normal(size=(40, spec.image, spec.image, 3)).astype(np.float32)
    labels = rng.integers(0, spec.num_classes, size=40)
    batches = [(images[i:i + 16], labels[i:i + 16]) for i in range(0, 40, 16)]
    fwd = lambda b, l, x: tvit.vit_forward_coalitions(b, l, x, spec)  # noqa: E731
    want = tev.make_coalition_evaluator(fwd)(
        base, stacked, [(torch.as_tensor(x).cuda(), torch.as_tensor(y).long().cuda())
                        for x, y in batches])
    wrappers = (patch_embed, fused_attention_packed, fused_mlp_block)
    before = [w.launches for w in wrappers]
    mesh = tmesh.make_mesh(*grid, devices=["cuda:0"] * (grid[0] * grid[1]))
    got = make_sharded_coalition_evaluator(fwd, mesh)(base, stacked, shard_batches(mesh, batches))
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-5, atol=0)
    # every cell ran each kernel on each of the 3 batches
    cells = grid[0] * grid[1]
    assert [w.launches - n for w, n in zip(wrappers, before)] == [
        3 * cells, 3 * cells * spec.depth, 3 * cells * spec.depth]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_sharded_train_step_on_cuda_grids(grid):
    """The multi-client LoRA step sharded over a grid of ``cuda:0`` against
    the single-device step on the card (tiny, float32, SGD with momentum,
    2 steps): losses within 1e-5 relative, overlays within 1e-5 of their
    largest magnitude; every cell launched the patch kernel once per
    client and ``fused_attention`` once per block, on ``tf32x3``."""
    _card()
    from shapley_vit_tpu_torch.fl import training as tr
    from shapley_vit_tpu_torch.ops.attention import fused_attention
    from shapley_vit_tpu_torch.ops.patch_embed import patch_embed
    from shapley_vit_tpu_torch.parallel.client_train import make_sharded_multi_client_train_step

    spec = tvit.make_spec("tiny", attention_impl="pallas", mlp_impl="xla")
    gen = torch.Generator().manual_seed(1)
    base = tvit.init_vit(gen, spec, device="cuda")
    lora = tvit.init_lora(gen, spec, classifier_from=base, device="cuda")
    stacked = ttm.tree_stack([ttm.tree_map(lambda a: a + 0.02 * torch.randn(
        a.shape, generator=gen).to("cuda"), lora) for _ in range(4)])
    images = torch.rand((4, 8, spec.image, spec.image, 3), generator=gen).cuda()
    labels = torch.randint(0, spec.num_classes, (4, 8), generator=gen).cuda()
    fwd = lambda b, l, x: tvit.vit_forward(b, l, x, spec)  # noqa: E731
    opt = tr.sgd(5e-3, momentum=0.9)
    single = tr.make_multi_client_train_step(fwd, opt, spec.num_classes)
    want_lora = tr.trainable(stacked)
    state = opt.init(want_lora)
    mesh = tmesh.make_mesh(*grid, devices=["cuda:0"] * (grid[0] * grid[1]))
    sharded = make_sharded_multi_client_train_step(fwd, opt, spec.num_classes, mesh)
    clients = sharded.init(stacked)
    wrappers = (patch_embed, fused_attention)
    for _ in range(2):
        want_lora, state, want = single(base, want_lora, state, images, labels)
        before = [dict(w.launches_by) for w in wrappers]
        clients, got = sharded(base, clients, images, labels)
        cells, k = grid[0] * grid[1], 4 // grid[0]
        new = [{key: n - old.get(key, 0) for key, n in w.launches_by.items()
                if n != old.get(key, 0)} for w, old in zip(wrappers, before)]
        assert [sum(d.values()) for d in new] == [cells * k, cells * k * spec.depth]
        assert all(key.startswith("tf32x3 float32") for d in new for key in d)
        torch.testing.assert_close(got, want.cpu(), rtol=1e-5, atol=0)
    for g, w in zip(ttm.tree_leaves(clients.stacked()), ttm.tree_leaves(want_lora)):
        w = w.detach().cpu()
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
