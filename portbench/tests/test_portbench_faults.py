"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a tiny size, with the cell's own limits: a sound run
is correct, and a run with one fault planted in the program is not. A
serving cell can have a token altered where it is produced and a step
that leaves its state unchanged (the K/V it computes never written); a
training cell a step that leaves its state unchanged and a loss taken as
the mean over half of the batch. One card has no exchange between
chips to leave out."""
import time

from skypilot_tpu_torch.models import decode, moe, train

from portbench.kinds import serve as serve_kind
from portbench.kinds import train as train_kind
from portbench_tiny import tiny_serve_cell, tiny_train_cell

SEED = 2**31 + 17


def run_serve():
    return serve_kind.run(tiny_serve_cell(), SEED, 2.0, False, 'cpu',
                          time.monotonic())


def run_train():
    return train_kind.run(tiny_train_cell(), SEED, 1.0, False, 'cpu',
                          time.monotonic())


def test_sound_serving_run_is_correct():
    outcome = run_serve()
    assert outcome.attempted > 0 and outcome.failed == 0
    assert outcome.correct, outcome.checks


def test_altered_token_is_not_correct(monkeypatch):
    vocab = tiny_serve_cell().config['vocab_size']
    sample = decode.sample

    def altered(logits, generator, temperature):
        return (sample(logits, generator, temperature) + 1) % vocab

    monkeypatch.setattr(decode, 'sample', altered)
    outcome = run_serve()
    assert not outcome.correct, outcome.checks


def test_unwritten_kv_is_not_correct(monkeypatch):
    monkeypatch.setattr(decode, '_write_kv', lambda *a, **k: None)
    outcome = run_serve()
    assert not outcome.correct, outcome.checks


def test_sound_training_run_is_correct():
    outcome = run_train()
    assert outcome.attempted > 0 and outcome.failed == 0
    assert outcome.correct, outcome.checks


def test_unchanged_state_is_not_correct(monkeypatch):
    make = train.make_optimizer

    def frozen(cfg):
        opt = make(cfg)
        return train.Optimizer(
            init=opt.init,
            update=lambda grads, state, params, grad_norm=None:
            train.global_norm(grads))

    monkeypatch.setattr(train, 'make_optimizer', frozen)
    outcome = run_train()
    assert not outcome.correct, outcome.checks


def test_half_batch_is_not_correct(monkeypatch):
    loss_fn = moe.loss_fn

    def half(params, tokens, targets, cfg, impl=None, mesh=None):
        n = tokens.shape[0] // 2
        return loss_fn(params, tokens[:n], targets[:n], cfg, impl, mesh)

    monkeypatch.setattr(moe, 'loss_fn', half)
    outcome = run_train()
    assert not outcome.correct, outcome.checks
