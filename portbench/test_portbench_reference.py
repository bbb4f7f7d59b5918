"""The reference against the program in float32 on the CPU, the weights'
layout against the program's, and the control apart from both."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from portbench import bench, families, serving, tiny, training, weights  # noqa: E402


def _program(model):
    from repro_torch.models.common import param_shapes

    cfg = bench.program_config(model)
    return cfg, param_shapes(cfg)


@pytest.mark.parametrize("workload", tiny.SERVE)
def test_layout_is_the_programs(workload):
    from repro_torch.tree import flatten

    run = bench.load(workload, 0, 1.0, False)
    model = run.model
    _, shapes = _program(model)
    layout = families.of(run.config).layout(model)
    mine = {k: (tuple(s), getattr(torch, d)) for k, (s, _, d) in layout.items()}
    theirs = {k: (tuple(s), d) for k, (s, d) in flatten(shapes).items()}
    assert mine == theirs


@pytest.mark.parametrize("workload", tiny.SERVE)
def test_reference_follows_prefill_and_decode_in_float32(workload):
    """The program in float32 (prefill, then decode through the cache)
    against one full reference pass over the prompt and the tokens."""
    from repro_torch.models import transformer

    run = tiny.run(workload)
    model, fam = run.model, families.of(run.config)
    params = weights.make(model, fam.layout(model), 3, "cpu")
    p32 = {k: v for k, v in weights.leaves(model, fam.layout(model), 3, "cpu")}
    p32 = weights.nest({k: v.float() for k, v in p32.items()})
    cfg = dataclasses.replace(bench.program_config(model), dtype=torch.float32,
                              param_dtype=torch.float32)
    prompt = torch.randint(0, model["vocab_size"], (1, 11), generator=torch.Generator().manual_seed(1))
    logits, cache = transformer.prefill(cfg, p32, prompt, max_len=24)
    outs, tok = [logits[0]], logits.argmax(-1)
    toks = [tok]
    for i in range(5):
        logits, cache = transformer.decode_step(cfg, p32, tok, cache,
                                                torch.tensor([11 + i], dtype=torch.int32))
        tok = logits.argmax(-1)
        outs.append(logits[0])
        toks.append(tok)
    seq = torch.cat([prompt[0], torch.cat(toks[:-1])])
    ref = fam.served_logits(model, params, [seq], [torch.arange(10, 16)])[0]
    prog = torch.stack(outs)[:, : model["vocab_size"]]
    assert torch.allclose(prog, ref, atol=2e-4, rtol=1e-4), (prog - ref).abs().max()


def test_reference_train_steps_follow_the_programs_in_float32():
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    run = tiny.run("olmo-1b.train")
    model, opt, fam = run.model, run.mix["optimizer"], families.for_training(run.config)
    cfg = dataclasses.replace(bench.program_config(model), dtype=torch.float32,
                              param_dtype=torch.float32, remat="none")
    flat = dict(weights.leaves(model, fam.layout(model), 4, "cpu"))
    params = weights.nest({k: v.float() for k, v in flat.items()})
    ocfg = OptConfig(**opt)
    state = init_opt_state(ocfg, params)
    step = make_train_step(cfg, ocfg)
    batches = [training._batch(run, i) for i in range(3)]
    losses = []
    for i, b in enumerate(batches):
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        if i == 0:
            grad = training.grad_norms(fam.layout(model), state, ocfg.b1)
    ref = fam.train_steps(model, opt, flat, [
        {k: torch.from_numpy(v) for k, v in b.items()} for b in batches])
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    for k in grad:
        assert grad[k] == pytest.approx(ref["grad_norm"][k], rel=1e-3)
    change = {k: float(torch.linalg.vector_norm(training._at(state["master"], k) - v.float()))
              for k, v in flat.items()}
    for k in change:
        assert change[k] == pytest.approx(ref["change"][k], rel=1e-3)


def test_control_reads_wider_than_the_program():
    """At a test's size: the served tokens and the float8 control's judged
    as a run judges them, the control not correct (the chip's readings at
    the cell's size, of both configurations, are in PERF.md).  olmo-1b's:
    at this size qwen2-moe's near-tied experts flip by the window's length."""
    run = tiny.run("olmo-1b.stream-code", seed=12)
    run.config["model"].update(d_model=128, vocab_size=1024)
    params, engine, spans = serving.setup(run)
    w = serving.window(run, engine, spans)
    picked = serving.sample(w["egress"], run.seed, 6)
    prog, ctrl = (serving.gap_numbers(serving.served_gaps(run, params, w["asked"], picked, c))
                  for c in (False, "fp8"))
    assert ctrl["served_logit_gap"] > 3 * prog["served_logit_gap"]
    assert bench.passed(bench.judge({"served_logit_gap": prog["served_logit_gap"]}, tiny.GAP_LIMIT))
    assert not bench.passed(bench.judge({"served_logit_gap": ctrl["served_logit_gap"]},
                                        tiny.GAP_LIMIT))
