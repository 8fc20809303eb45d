"""The check against faults in the timed path, at a tiny size on the CPU:
a run of the cell with the program broken underneath comes out not
correct, by the cell's own limits, where the same run unbroken comes out
correct. Faults: a step that leaves its state unchanged and a step that
leaves half of its batch out (training); an answer altered where it is
produced (evaluation); the exchange between cards left out (the mesh).
And each cell's control, the reference in fp8 in the program's place,
reads well above the sound runs."""

import pytest
import torch
import torch.nn.functional as F

from conftest import run_tiny, tiny_context

SEEDS = [2**31 + 21, 2**31 + 22]


def _run(workload, seed):
    ctx = tiny_context(workload, seed=seed)
    assert ctx.limits, f"{workload} has no limits"
    out, line = run_tiny(ctx)
    return out, line


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ["vitb16-n3", "vitl16-n3", "vitb16-train-b64", "vitb16-n5-mesh4"])
def test_sound_run_is_correct(workload, seed, one_thread):
    out, line = _run(workload, seed)
    assert line["correct"], line["checks"]


def test_training_step_that_leaves_state_unchanged(monkeypatch, one_thread):
    from shapley_vit_tpu_torch.fl import training as tr

    def make_frozen(forward_fn, num_classes, label_flip_prob=0.0):
        def step(base, lora, opt_state, images, labels, generator=None):
            opt_state.zero_grad(set_to_none=True)
            loss = tr.cross_entropy(forward_fn(base, lora, images), labels)
            loss.backward()
            return lora, opt_state, loss.detach()  # no update
        return step

    monkeypatch.setattr(tr, "make_train_step", make_frozen)
    out, line = _run("vitb16-train-b64", SEEDS[0])
    assert not line["correct"]
    assert line["checks"]["change_norm_gap"]["value"] > line["checks"]["change_norm_gap"]["limit"]


def test_training_step_that_leaves_half_the_batch_out(monkeypatch, one_thread):
    from shapley_vit_tpu_torch.fl import training as tr

    def half(logits, labels):
        h = len(labels) // 2
        return F.cross_entropy(logits[:h].float(), labels[:h].long())

    monkeypatch.setattr(tr, "cross_entropy", half)
    out, line = _run("vitb16-train-b64", SEEDS[0])
    assert not line["correct"]
    assert line["checks"]["grad_rel_err"]["value"] > line["checks"]["grad_rel_err"]["limit"]


@pytest.mark.parametrize("workload", ["vitb16-n3", "vitb16-n5-mesh4"])
def test_answer_altered_where_produced(workload, monkeypatch, one_thread):
    from shapley_vit_tpu_torch.parallel import coalition_eval as ce

    produce = ce.masked_eval_step_metrics

    def altered(logits, labels, weights):
        c, l = produce(logits, labels, weights)
        bump = torch.zeros_like(l)
        bump[-1] = 0.05 * l[-1]
        return c, l + bump

    monkeypatch.setattr(ce, "masked_eval_step_metrics", altered)
    out, line = _run(workload, SEEDS[0])
    assert not line["correct"]


def test_mesh_exchange_left_out(monkeypatch, one_thread):
    from shapley_vit_tpu_torch.parallel.mesh import Mesh

    cells = Mesh.local_cells

    def first_data_shard_only(self):
        return [c for c in cells(self) if c[1] == 0]

    monkeypatch.setattr(Mesh, "local_cells", first_data_shard_only)
    out, line = _run("vitb16-n5-mesh4", SEEDS[0])
    assert not line["correct"]


@pytest.mark.parametrize("workload", ["vitb16-n3", "vitb16-n5-mesh4"])
def test_evaluation_control_fp8_separates(workload, one_thread):
    """The control, the reference computed in fp8 in the program's place,
    reads the compared loss number well above the bf16 program on the same
    inputs (on the card, at the cell's size, it fails the cell's limit:
    ``calibrate.py --control``)."""
    read = {}
    for mode, extra in (("program", {}), ("fp8", {"reference_quant": "fp8"})):
        ctx = tiny_context(workload, seed=SEEDS[1], overrides={"rounds": 4, **extra})
        out, _ = run_tiny(ctx)
        read[mode] = out.readings
    assert read["fp8"]["loss_rms"] >= 3 * read["program"]["loss_rms"], read


def test_training_control_fp8_separates(one_thread):
    """The training cell's control, the reference computed in fp8 in the
    program's place, reads the first gradient's difference well above the
    bf16 program on the same inputs (on the card, at the cell's size, it
    fails the cell's limit: ``calibrate.py --control``)."""
    read = {}
    for mode, extra in (("program", {}), ("fp8", {"reference_quant": "fp8"})):
        ctx = tiny_context("vitb16-train-b64", seed=SEEDS[1], overrides={"steps": 2, **extra})
        out, _ = run_tiny(ctx)
        read[mode] = out.readings
    assert read["fp8"]["grad_rel_err"] >= 3 * read["program"]["grad_rel_err"], read
