"""The plain reference against the port, at the port's ``debug`` and
``moe-debug`` sizes on the CPU, both in fp32 on the same weights: the
dense forward's logits, the mixture of experts' loss and gradients, and
three AdamW steps. The reference imports nothing of the port; this test
imports both."""
import dataclasses

import pytest
import torch

from portbench import reference, weights
from skypilot_tpu_torch.models import llama, moe, train

DEBUG = weights.Dims(vocab=256, dim=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, ffn_dim=128, rope_theta=1e6,
                     norm_eps=1e-5)
MOE_DEBUG = weights.Dims(vocab=256, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, ffn_dim=96, rope_theta=1e6,
                         norm_eps=1e-5, n_experts=4, top_k=2,
                         capacity_factor=1.25, router_aux_coef=0.02)
OPT = {'learning_rate': 3e-4, 'weight_decay': 0.1, 'beta1': 0.9,
       'beta2': 0.95, 'grad_clip': 1.0, 'warmup_steps': 1,
       'moment_dtype': 'float32'}


def fp32_params(d, seed):
    params = weights.make_params(d, seed, 'cpu')
    return train.tree_map(lambda t: t.float(), params)


def port_config(d, cls=llama.LlamaConfig, **kw):
    cfg = llama.CONFIGS['debug'] if cls is llama.LlamaConfig else \
        moe.CONFIGS['moe-debug']
    return dataclasses.replace(
        cfg, vocab_size=d.vocab, dim=d.dim, n_layers=d.n_layers,
        n_heads=d.n_heads, n_kv_heads=d.n_kv_heads, ffn_dim=d.ffn_dim,
        rope_theta=d.rope_theta, norm_eps=d.norm_eps, dtype=torch.float32,
        **kw)


@pytest.mark.parametrize('seed', [3, 2**31 + 9])
def test_dense_logits_match_the_port(seed):
    params = fp32_params(DEBUG, seed)
    cfg = port_config(DEBUG)
    tokens = torch.randint(0, DEBUG.vocab, (1, 40),
                           generator=torch.Generator().manual_seed(seed))
    want = llama.forward(params, tokens, cfg)[0]
    rows = torch.arange(40)
    got = reference.served_logits(params, DEBUG, [tokens[0]], [rows],
                                  {'ref': reference.fp32_mm})['ref'][0]
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)
    assert reference.widest_gap(got, want.argmax(-1)) == 0.0


def moe_port_config():
    return port_config(MOE_DEBUG, moe.MoeConfig, n_experts=4, top_k=2,
                       capacity_factor=1.25, router_aux_coef=0.02,
                       remat=False)


def test_moe_loss_and_grads_match_the_port():
    params = fp32_params(MOE_DEBUG, 5)
    cfg = moe_port_config()
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, MOE_DEBUG.vocab, (2, 32), generator=gen)
    targets = torch.roll(tokens, -1, dims=1)
    want_loss, want_grads = train.value_and_grad(params, tokens, targets,
                                                 cfg)
    paths = [p for p, _ in reference.leaves(params)]
    tree = {}
    for p in paths:
        weights.set_leaf(tree, p, weights.get_leaf(params, p).clone()
                         .requires_grad_(True))
    loss = reference.moe_loss(tree, tokens, targets, MOE_DEBUG,
                              reference.fp32_mm)
    grads = torch.autograd.grad(loss, [weights.get_leaf(tree, p)
                                       for p in paths])
    assert abs(float(loss.detach()) - float(want_loss)) < 1e-5
    for p, g in zip(paths, grads):
        w = weights.get_leaf(want_grads, p)
        assert torch.allclose(g, w, atol=1e-6, rtol=1e-4), p


def test_three_adamw_steps_match_the_port():
    params = fp32_params(MOE_DEBUG, 6)
    ours = train.tree_map(lambda t: t.clone(), params)
    cfg = moe_port_config()
    tcfg = train.TrainConfig(**OPT)
    step = train.make_train_step(cfg, tcfg)
    state = train.TrainState(params=params,
                             opt_state=train.make_optimizer(tcfg).init(
                                 params), step=0)
    paths = [p for p, _ in reference.leaves(ours)]
    ref_state = {'count': 0,
                 'mu': {p: torch.zeros_like(weights.get_leaf(ours, p))
                        for p in paths},
                 'nu': {p: torch.zeros_like(weights.get_leaf(ours, p))
                        for p in paths}}
    for i in range(3):
        gen = torch.Generator().manual_seed(100 + i)
        tokens = torch.randint(0, MOE_DEBUG.vocab, (2, 32), generator=gen)
        targets = torch.roll(tokens, -1, dims=1)
        state, _ = step(state, tokens, targets)
        tree = {}
        for p in paths:
            weights.set_leaf(tree, p, weights.get_leaf(ours, p).clone()
                             .requires_grad_(True))
        loss = reference.moe_loss(tree, tokens, targets, MOE_DEBUG,
                                  reference.fp32_mm)
        grads = torch.autograd.grad(loss, [weights.get_leaf(tree, p)
                                           for p in paths])
        gtree = {}
        for p, g in zip(paths, grads):
            weights.set_leaf(gtree, p, g)
        with torch.no_grad():
            reference.adamw_step(ours, gtree, ref_state, OPT)
    for p in paths:
        got, want = weights.get_leaf(ours, p), weights.get_leaf(
            state.params, p)
        assert torch.allclose(got, want, atol=1e-6, rtol=1e-5), p


def test_learning_rate_schedule_matches_the_port():
    tcfg = train.TrainConfig(learning_rate=3e-4, warmup_steps=10)
    opt = {'learning_rate': 3e-4, 'warmup_steps': 10}
    for count in (0, 1, 5, 10, 11, 500, 999, 1000, 2000):
        assert reference.learning_rate(opt, count) == pytest.approx(
            train.learning_rate(tcfg, count), rel=1e-6, abs=1e-10)


def test_fp8_products_are_coarser_than_fp32():
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(16, 64, generator=gen)
    b = torch.randn(64, 8, generator=gen)
    exact = a @ b
    err = (reference.fp8_mm(a, b) - exact).abs().max() / exact.abs().max()
    assert 1e-3 < float(err) < 0.2
