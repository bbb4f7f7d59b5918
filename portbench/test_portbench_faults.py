"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run at a test's size on the CPU (the look
for a card skipped), with one fault planted in the program, and with the
cell's own limits: a step that leaves its state unchanged, half of the
batch left out, a token altered where it is produced.  (One chip: no
exchange between chips to leave out.)  The sound run comes out correct."""
import pytest

torch = pytest.importorskip("torch")

from portbench import serving, tiny, training  # noqa: E402

SERVE = tiny.SERVE


def _serve(workload):
    run = tiny.run(workload, seed=21)
    result, checks = serving.run_cell(run)
    return result, checks


def _no_cache_write(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "write_at", lambda cache, new, position: None)


def _half_batch(monkeypatch):
    from repro_torch.models import transformer
    real = transformer.decode_step

    def half(cfg, params, token, cache, position):
        logits, cache = real(cfg, params, token, cache, position)
        h = logits.shape[0] // 2  # the second half of the slots not computed
        return torch.cat([logits[:h], logits[:h].roll(1, -1)]), cache

    monkeypatch.setattr(transformer, "decode_step", half)


def _altered_token(monkeypatch):
    from repro_torch.serve.engine import OrderedServingEngine
    real = OrderedServingEngine._decode
    calls = {"n": 0}

    def altered(self, params, tokens, cache, position):
        nxt, cache = real(self, params, tokens, cache, position)
        calls["n"] += 1  # one slot's token a step, in turn
        b = calls["n"] % nxt.shape[0]
        nxt = nxt.clone()
        nxt[b] = (nxt[b] + self.cfg.vocab_size // 2) % self.cfg.vocab_size
        return nxt, cache

    monkeypatch.setattr(OrderedServingEngine, "_decode", altered)


def _one_slot_wrong(monkeypatch):
    from repro_torch.serve.engine import OrderedServingEngine
    real = OrderedServingEngine._decode

    def wrong(self, params, tokens, cache, position):
        nxt, cache = real(self, params, tokens, cache, position)
        nxt = nxt.clone()  # slot 0's every decoded token altered
        nxt[0] = (nxt[0] + self.cfg.vocab_size // 2) % self.cfg.vocab_size
        return nxt, cache

    monkeypatch.setattr(OrderedServingEngine, "_decode", wrong)


@pytest.mark.parametrize("workload", SERVE)
def test_sound_serving_run_is_correct(workload):
    result, checks = _serve(workload)
    assert result["correct"], checks


@pytest.mark.parametrize("fault", [_no_cache_write, _half_batch, _altered_token, _one_slot_wrong],
                         ids=["state_unchanged", "half_batch", "altered_token", "one_slot_wrong"])
@pytest.mark.parametrize("workload", SERVE)
def test_broken_serving_run_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result, checks = _serve(workload)
    assert not result["correct"], checks


def test_one_wrong_request_among_sound_ones_is_not_correct():
    """qwen2-moe's limits at the cell's own size: 15 sampled requests as
    sound runs read them (5% of their tokens off, none mostly) and one
    whose 12 tokens are all off.  The share stays under its limit; the
    count of requests mostly off does not."""
    from portbench import bench

    limits = bench.data("cells", "qwen2-moe-a2.7b.stream-code")["limits"]
    sound = [torch.tensor([0.0] * 19 + [0.7]) for _ in range(15)]
    numbers = serving.gap_numbers(sound + [torch.full((12,), 3.0)])
    assert numbers["served_off_pct"] < limits["served_off_pct"]
    checks = bench.judge({k: numbers[k] for k in ("served_off_pct", "half_off_requests")}, limits)
    assert not bench.passed(checks)
    assert bench.passed(bench.judge({"half_off_requests": serving.gap_numbers(sound)[
        "half_off_requests"]}, limits))


def test_sound_training_run_is_correct():
    result, checks = training.run_cell(tiny.run("olmo-1b.train", seed=8, seconds=0.5))
    assert result["correct"], checks


def _no_update(monkeypatch):
    from repro_torch.train import train_step

    def frozen(ocfg, params, grads, state):
        z = torch.zeros(())
        return params, state, {"lr": z, "grad_norm": z}

    monkeypatch.setattr(train_step, "apply_adamw", frozen)


def _half_rows(monkeypatch):
    from repro_torch.models import transformer
    real = transformer.loss_fn

    def half(cfg, params, batch):
        h = batch["tokens"].shape[0] // 2
        return real(cfg, params, {k: v[:h] for k, v in batch.items()})

    monkeypatch.setattr(transformer, "loss_fn", half)


@pytest.mark.parametrize("fault", [_no_update, _half_rows], ids=["state_unchanged", "half_batch"])
def test_broken_training_run_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, checks = training.run_cell(tiny.run("olmo-1b.train", seed=8, seconds=0.5))
    assert not result["correct"], checks
