"""The comparison that decides ``correct``, run end to end on the CPU at
small widths (the harness's look for a card skipped): each plain reference
against the port, sound runs passing the cell's limits; then the faults a
training cell can have planted under the timed path, and the control (the
reference in float8 in the program's place), each failing them."""

import pytest
import torch

from gan_bench import calibrate, run
from gan_bench.tests.conftest import PGGAN, SNGAN, small

CELLS = (SNGAN, PGGAN)
SEED = 2**31 + 77


def _run(cell, hook=None, dtype="fp32", seed=SEED):
    return run.run_cell(cell, seed, 0.5, False, device="cpu", require_card=False,
                        overrides=small(cell, dtype), program_hook=hook)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_port_at_small_width(cell):
    result = _run(cell)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    # float32 on both sides: the gaps are round-off, far under any limit
    assert all(c["value"] < 1e-3 for c in result["checks"].values()), result["checks"]


def _unchanged(prog):
    """The step returns its state as it found it."""
    step = prog.step_fn

    def fault(state, batch):
        saved = {n: t.detach().clone() for n, t in prog.tensors().items()}
        metrics = step(state, batch)
        with torch.no_grad():
            for n, t in prog.tensors().items():
                t.copy_(saved[n])
            for opt in (state.g_opt, state.d_opt):  # Adam's slots as they start
                for slots in opt.state.values():
                    slots["exp_avg"].zero_()
                    slots["exp_avg_sq"].zero_()
        return metrics

    prog.step_fn = fault


def _half_batch(prog):
    """Half of every batch left out; the losses' means over the rest."""
    step = prog.step_fn

    def fault(state, batch):
        return step(state, {k: v[:, :v.shape[1] // 2] for k, v in batch.items()})

    prog.step_fn = fault


def _kept(prefix):
    """The step leaves one group of its state (``prefix``: ``ema.`` G's EMA,
    ``dbuf.`` the spectral norms' ``u``, ``gbuf.`` G's batch-norm
    statistics) as it found it, and updates the rest."""
    def plant(prog):
        step = prog.step_fn

        def fault(state, batch):
            held = {n: t for n, t in prog.tensors().items() if n.startswith(prefix)}
            assert held, prefix
            saved = {n: t.detach().clone() for n, t in held.items()}
            metrics = step(state, batch)
            with torch.no_grad():
                for n, t in held.items():
                    t.copy_(saved[n])
            return metrics

        prog.step_fn = fault
    return plant


FAULTS = [(cell, _unchanged, "unchanged") for cell in CELLS] + \
    [(cell, _half_batch, "half_batch") for cell in CELLS] + \
    [(cell, _kept("ema."), "ema_kept") for cell in CELLS] + \
    [(SNGAN, _kept("dbuf."), "u_kept"), (SNGAN, _kept("gbuf."), "bn_stats_kept")]


@pytest.mark.parametrize("cell,fault", [f[:2] for f in FAULTS],
                         ids=[f"{f[2]}-{f[0]}" for f in FAULTS])
def test_a_broken_step_is_not_correct(cell, fault):
    result = _run(cell, hook=fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    """The reference in float8 put in the program's place reads above a
    limit of the cell on every seed tried."""
    limits = run.load_json("workloads", cell)["limits"]
    for seed in (3, 2**40 + 5):
        row = next(r for r in calibrate.readings(cell, seed, ("control",), device="cpu",
                                                 overrides=small(cell), require_card=False))
        assert any(row[k] > limits[k] for k in limits), row


def test_a_run_finding_no_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", SNGAN, "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 3 and out.out == "" and "CUDA" in out.err


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(card, cell):
    result = run.run_cell(cell, SEED, 2.0, False, device=card)
    assert result["correct"], result["checks"]


def test_a_hinge_logit_at_its_kink_counts_either_way():
    """A logit within the margin of its kink gives two gradients, the
    reference's own among them, and ``grad_d_gap`` takes the nearer."""
    from gan_bench.correct import gaps
    from gan_bench.reference.plain import kink_alternatives, norms

    gen = torch.Generator().manual_seed(0)
    w = torch.randn(3, generator=gen, requires_grad=True)
    x = torch.randn(4, 3, generator=gen)
    logits = x @ w
    kinks = logits.detach() + torch.tensor([1e-4, 5.0, 5.0, -5.0])  # only sample 0 is near
    slopes = torch.full((4,), -0.25)  # relu(kink - logit) / 4: counted where logit < kink
    loss = (torch.relu(kinks - logits) / 4).sum()
    (grad,) = torch.autograd.grad(loss, [w], retain_graph=True)
    alts = kink_alternatives(logits, kinks, slopes, [grad], [w], ["d.w"], margin=1e-3)
    without = torch.autograd.grad((torch.relu(kinks - logits)[1:] / 4).sum(), [w],
                                  retain_graph=True)[0]
    assert sorted(a["d.w"] for a in alts) == pytest.approx(
        sorted([float(grad.norm()), float(without.norm())]))
    other = {"d.w": float(without.norm())}
    ref = {"losses": [], "grad": norms({"d.w": grad}), "change": {}, "grad_alternatives": alts}
    prog = {"losses": [], "grad": other, "change": {}}
    assert gaps(prog, ref)[0]["grad_d_gap"] == pytest.approx(0.0, abs=1e-6)
    assert gaps(prog, {**ref, "grad_alternatives": None})[0]["grad_d_gap"] > 1e-3
