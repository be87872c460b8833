"""Port training path (skypilot_tpu_torch/models/train.py, checkpoint.py,
data.py, llama.loss_fn, convert.train_state_from_numpy) against the JAX
reference on the ``debug`` config.

Weights and optimizer state are the reference's own, bridged through
``models/convert.py``; batches are the reference's numpy stream. The
reference's flash attention runs its dense fallback on the CPU (as its
own tests run it), the port its plain twins.

Tolerances. fp32 (the parity claim): loss rel 2e-5; each grad leaf
within 2e-4 of its largest |value|; train-step losses and grad norms rel
2e-5, params after the steps atol 2e-5 — summation order only. bf16
(both frameworks round to bf16, XLA may fuse chains without rounding in
between, eager PyTorch rounds after every op), measured here before the
bounds were set: loss within 2e-4 of 5.56 (bound 2e-3), grad leaves
within 1.2% in norm (bound 3e-2) and 1.8% of the largest |value| (bound
3e-2), grad norms equal (bound rel 1e-2), params after 5 steps within
3.8e-3 (bound 7.9e-3: one bf16 ulp at 1.0).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.models import data as jdata
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import train as jtrain
from skypilot_tpu_torch.models import checkpoint as tckpt
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import data as tdata
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import train as ttrain

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 2e-5
F32_GRAD_TOL = 2e-4
BF16 = dict(loss=2e-3, grad=3e-2, grad_norm=1e-2, params=7.9e-3)


def _configs(dtype_name, **overrides):
    jcfg = dataclasses.replace(jllama.CONFIGS['debug'], **overrides)
    tcfg = dataclasses.replace(tllama.CONFIGS['debug'], **overrides)
    if dtype_name == 'fp32':
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return jcfg, tcfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _batch(seed=1, b=2, s=32):
    return ttrain.synthetic_batch(256, b, s, seed, 0)


def _port_value_and_grad(tparams, tokens, targets, tcfg):
    leaves = ttrain.tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss = tllama.loss_fn(tparams, torch.from_numpy(tokens),
                          torch.from_numpy(targets), tcfg)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize('dtype_name,flash,ce_chunks,remat', [
    ('fp32', False, 1, False), ('fp32', True, 1, False),
    ('fp32', True, 2, True), ('fp32', False, 2, True),
    ('bf16', False, 1, False), ('bf16', True, 2, True)])
def test_loss_and_grads_match_reference(dtype_name, flash, ce_chunks, remat):
    jcfg, tcfg = _configs(dtype_name, flash_attention=flash,
                          ce_chunks=ce_chunks, remat=remat)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(_np(jparams), tcfg)
    tokens, targets = _batch()
    loss, grads = jax.value_and_grad(jllama.loss_fn)(
        jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    t_loss, t_grads = _port_value_and_grad(tparams, tokens, targets, tcfg)
    assert t_loss.dtype == torch.float32 and t_loss.dim() == 0
    leaves = jax.tree.leaves(grads)
    assert len(leaves) == len(t_grads)
    for ref, got in zip(leaves, t_grads):
        assert got.dtype == tcfg.dtype and got.shape == ref.shape
    if dtype_name == 'fp32':
        np.testing.assert_allclose(t_loss.item(), float(loss), rtol=F32_TOL)
        for ref, got in zip(leaves, t_grads):
            ref = _f32(ref)
            np.testing.assert_allclose(_f32(got), ref, rtol=0,
                                       atol=F32_GRAD_TOL *
                                       np.abs(ref).max())
    else:
        assert abs(t_loss.item() - float(loss)) <= BF16['loss']
        for ref, got in zip(leaves, t_grads):
            ref, got = _f32(ref), _f32(got)
            assert (np.linalg.norm(got - ref) <=
                    BF16['grad'] * np.linalg.norm(ref))
            assert np.abs(got - ref).max() <= BF16['grad'] * np.abs(ref).max()


def _run_both(dtype_name, tcfg_kwargs, n_steps, mid_run=0):
    """n_steps of the reference's and the port's train step on the same
    bridged state and batches. With ``mid_run``, the reference first
    runs that many steps alone and the port starts from its state."""
    jcfg, tcfg = _configs(dtype_name)
    jtc = jtrain.TrainConfig(**tcfg_kwargs)
    ttc = ttrain.TrainConfig(**tcfg_kwargs)
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, jtc)
    jstep = jtrain.make_train_step(jcfg, jtc)
    for i in range(mid_run):
        jstate, _ = jstep(jstate, *_batch(seed=i))
    tstate = convert.train_state_from_numpy(
        _np(jstate.params), _np(jstate.opt_state[1][0]), tcfg)
    assert tstate.step == int(jstate.step) == mid_run
    tstep = ttrain.make_train_step(tcfg, ttc)
    metrics = []
    for i in range(mid_run, mid_run + n_steps):
        tokens, targets = _batch(seed=i)
        jstate, jm = jstep(jstate, tokens, targets)
        tstate, tm = tstep(tstate, tokens, targets)
        metrics.append((float(jm['loss']), float(tm['loss']),
                        float(jm['grad_norm']), float(tm['grad_norm'])))
    assert tstate.step == int(jstate.step)
    return jstate, tstate, metrics


def _check_states(jstate, tstate, atol):
    pairs = list(zip(jax.tree.leaves(jstate.params),
                     ttrain.tree_leaves(tstate.params)))
    adam = jstate.opt_state[1][0]
    pairs += zip(jax.tree.leaves(adam.mu),
                 ttrain.tree_leaves(tstate.opt_state.mu))
    assert tstate.opt_state.count == int(adam.count)
    for ref, got in pairs:
        assert str(got.dtype).split('.')[-1] == str(ref.dtype)
        np.testing.assert_allclose(_f32(got), _f32(ref), rtol=0, atol=atol)


@pytest.mark.parametrize('moment_dtype', ['float32', 'bfloat16'])
def test_train_steps_match_reference_fp32(moment_dtype):
    """Warmup 2 at lr 1e-3: step 1 at lr 0, then warmup, clipping (the
    debug model's grad norm is above 1) and weight decay."""
    jstate, tstate, metrics = _run_both(
        'fp32', dict(learning_rate=1e-3, warmup_steps=2,
                     moment_dtype=moment_dtype), n_steps=4)
    for jl, tl, jn, tn in metrics:
        np.testing.assert_allclose(tl, jl, rtol=F32_TOL)
        np.testing.assert_allclose(tn, jn, rtol=F32_TOL)
    assert metrics[0][2] > 1.0        # the clip branch ran
    _check_states(jstate, tstate, F32_TOL)


@pytest.mark.parametrize('moment_dtype', ['float32', 'bfloat16'])
def test_train_steps_match_reference_bf16(moment_dtype):
    jstate, tstate, metrics = _run_both(
        'bf16', dict(learning_rate=1e-3, warmup_steps=2,
                     moment_dtype=moment_dtype), n_steps=5)
    for jl, tl, jn, tn in metrics:
        assert abs(tl - jl) <= BF16['loss']
        assert abs(tn - jn) <= BF16['grad_norm'] * jn
    _check_states(jstate, tstate, BF16['params'])


def test_mid_run_start_from_reference_state():
    jstate, tstate, metrics = _run_both(
        'fp32', dict(learning_rate=1e-3, warmup_steps=2), n_steps=2,
        mid_run=3)
    for jl, tl, jn, tn in metrics:
        np.testing.assert_allclose(tl, jl, rtol=F32_TOL)
        np.testing.assert_allclose(tn, jn, rtol=F32_TOL)
    _check_states(jstate, tstate, F32_TOL)


def test_train_state_from_numpy_keeps_bf16_moments_bit_exact():
    jcfg, tcfg = _configs('bf16')
    tc = jtrain.TrainConfig(learning_rate=1e-3, warmup_steps=1)
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, tc)
    jstate, _ = jtrain.make_train_step(jcfg, tc)(jstate, *_batch())
    adam = _np(jstate.opt_state[1][0])
    tstate = convert.train_state_from_numpy(_np(jstate.params), adam, tcfg,
                                            step=7)
    assert tstate.step == 7 and tstate.opt_state.count == 1
    ref = adam.nu['layers']['w1']
    got = tstate.opt_state.nu['layers']['w1']
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  ref.view(np.int16))


@pytest.mark.parametrize('warmup', [1, 5, 10, 100])
def test_schedule_matches_optax(warmup):
    cfg = ttrain.TrainConfig(warmup_steps=warmup)
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, warmup, max(10 * warmup, 1000))
    for count in (0, 1, 2, warmup - 1, warmup, warmup + 1, 500, 999, 1000,
                  5000):
        np.testing.assert_allclose(
            ttrain.learning_rate(cfg, count),
            float(schedule(jnp.asarray(count, jnp.int32))), rtol=1e-6,
            atol=1e-12)
    if warmup == 5:   # step 1 runs at lr 0, step 2 at peak / warmup
        assert ttrain.learning_rate(cfg, 0) == 0.0
        np.testing.assert_allclose(ttrain.learning_rate(cfg, 1), 6e-5,
                                   rtol=1e-6)


def test_loss_falls_on_a_fixed_batch():
    cfg = tllama.CONFIGS['debug']
    tc = ttrain.TrainConfig(learning_rate=1e-3, warmup_steps=1)
    state = ttrain.init_train_state(cfg, tc, 'cpu')
    step = ttrain.make_train_step(cfg, tc)
    tokens, targets = _batch(b=4)
    losses = []
    for _ in range(8):
        state, metrics = step(state, tokens, targets)
        losses.append(float(metrics['loss']))
    assert losses[-1] < losses[0] * 0.9, losses
    assert state.step == 8 and state.opt_state.count == 8


def test_checkpoint_resume_equals_unbroken_run(tmp_path):
    cfg = tllama.CONFIGS['debug']
    tc = ttrain.TrainConfig(warmup_steps=2)

    def run(n, ckpt_dir=None, save_every=100):
        losses = {}
        state = ttrain.train_loop(
            cfg, tc, n, 2, 32, checkpoint_dir=ckpt_dir,
            save_every=save_every, keep=2, log_every=0, device='cpu',
            on_step=lambda i, m: losses.__setitem__(i, float(m['loss'])))
        return state, losses

    unbroken, losses = run(5)
    ckpt_dir = str(tmp_path / 'ckpt')
    _, first = run(3, ckpt_dir, save_every=1)
    assert tckpt.list_steps(ckpt_dir) == [2, 3]            # keep=2
    # A save that never committed is not resumed from.
    os.makedirs(os.path.join(ckpt_dir, 'step_9'))
    assert tckpt.list_steps(ckpt_dir) == [2, 3]
    resumed, rest = run(5, ckpt_dir)
    assert sorted(first) == [1, 2, 3] and sorted(rest) == [4, 5]
    assert {**first, **rest} == losses
    assert resumed.step == unbroken.step == 5
    for got, want in zip(ttrain.tree_leaves(resumed.params) +
                         ttrain.tree_leaves(resumed.opt_state.nu),
                         ttrain.tree_leaves(unbroken.params) +
                         ttrain.tree_leaves(unbroken.opt_state.nu)):
        assert torch.equal(got, want)
    assert tckpt.list_steps(ckpt_dir) == [3, 5]


def test_token_dataset_copy_matches_reference(tmp_path):
    text = tmp_path / 'corpus.txt'
    text.write_text('the quick brown fox jumps over the lazy dog\n' * 40)
    path = str(tmp_path / 'corpus.bin')
    jdata.encode_text(str(text), path, 256)
    ours = tdata.TokenDataset.open(path)
    assert ours.vocab_size == 256 and ours.tokens.dtype == np.uint16
    theirs = jdata.TokenDataset.open(path)
    for step in (0, 1, 7):
        for a, b in zip(ours.batch(step, 3, 16, seed=5),
                        theirs.batch(step, 3, 16, seed=5)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('vocab_size', [32768, 65536, 65537, 128256])
def test_encode_text_writes_the_reference_bytes(tmp_path, monkeypatch,
                                                vocab_size):
    """The port's token-file tool (through its ``encode`` command line)
    and the reference's ``encode_text`` write the same token file and
    the same sidecar, uint16 up to a vocabulary of 65,536 and uint32
    past it."""
    text = tmp_path / 'corpus.txt'
    text.write_text('the quick brown fox\n\njumps  over the lazy dog\n'
                    'naïve café 42 §\n' * 7, encoding='utf-8')
    for side in ('ours', 'theirs'):
        (tmp_path / side).mkdir()
    n = jdata.encode_text(str(text), str(tmp_path / 'theirs' / 'c.bin'),
                          vocab_size)
    monkeypatch.setattr(sys, 'argv', [
        'data', 'encode', str(text), str(tmp_path / 'ours' / 'c.bin'),
        '--vocab-size', str(vocab_size)])
    tdata.main()
    for name in ('c.bin', 'c.json'):
        assert ((tmp_path / 'ours' / name).read_bytes() ==
                (tmp_path / 'theirs' / name).read_bytes()), name
    tokens = tdata.TokenDataset.open(str(tmp_path / 'ours' / 'c.bin'))
    assert tokens.tokens.size == n and tokens.vocab_size == vocab_size
    assert tokens.tokens.dtype == (np.uint16 if vocab_size <= 65536
                                   else np.uint32)


def test_flash_prefill_matches_reference():
    """With ``flash_attention`` set, prefill runs the flash path (the
    plain twins here, the dense fallback in the reference) and agrees
    with the reference's prefill and with the port's dense path."""
    from skypilot_tpu.models import decode as jdecode
    from skypilot_tpu_torch.models import decode as tdecode
    jcfg, tcfg = _configs('fp32', flash_attention=True)
    jparams = jllama.init_params(jax.random.PRNGKey(2), jcfg)
    tparams = convert.params_from_numpy(_np(jparams), tcfg)
    tokens = _batch(seed=3)[0]
    lens = np.array([32, 17], np.int32)
    ref, _ = jdecode.prefill(jparams, jnp.asarray(tokens), jcfg,
                             jdecode.init_kv_cache(jcfg, 2, 64),
                             jnp.asarray(lens))
    outs = [tdecode.prefill(tparams, torch.from_numpy(tokens), cfg,
                            tdecode.init_kv_cache(cfg, 2, 64),
                            torch.from_numpy(lens))
            for cfg in (tcfg, dataclasses.replace(tcfg,
                                                  flash_attention=False))]
    for out in outs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=F32_TOL, rtol=F32_TOL)


def _cli_gang(n, extra):
    """``n`` processes of the trainer's CLI as a gang (the gang's env
    triple), one thread each; returns their (code, stdout, stderr)."""
    from skypilot_tpu_torch.parallel import distributed  # pylint: disable=import-outside-toplevel
    port = distributed.free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ('PYTHONPATH', 'MEGASCALE_NUM_SLICES',
                        'SKYTPU_DISABLE_JAX_DISTRIBUTED')}
    env.update(OMP_NUM_THREADS='1', JAX_NUM_PROCESSES=str(n),
               JAX_COORDINATOR_ADDRESS=f'127.0.0.1:{port}')
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.models.train',
           '--model', 'debug', '--device', 'cpu', '--steps', '2',
           '--log-every', '1', '--seq-len', '32', '--batch-size', '4'] + extra
    procs = [subprocess.Popen(cmd, cwd=REPO_ROOT, env=dict(
        env, JAX_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def test_unported_remat_policies_and_multislice_are_refused():
    """Every remat policy is ported (tests/test_torch_remat.py), and the
    trainer CLI now refuses neither multi-process nor multislice
    training: a two-process gang (fsdp over both) and a four-process
    gang with ``--num-slices 2`` (dcn 2, fsdp 2) each train the global
    batch, rank 0 alone printing, with the losses of one process."""
    want = {}
    ttrain.train_loop(tllama.CONFIGS['debug'],
                      ttrain.TrainConfig(warmup_steps=5), 2, 4, 32,
                      log_every=0, device='cpu',
                      on_step=lambda i, m: want.__setitem__(
                          i, f'{float(m["loss"]):.4f}'))
    for n, extra in ((2, []), (4, ['--num-slices', '2'])):
        results = _cli_gang(n, extra)
        for code, out, err in results:
            assert code == 0, err[-3000:]
        lead = results[0][1]
        for i in (1, 2):
            assert f'[train] step {i}/2 loss={want[i]}' in lead, lead
        assert '[train] done at step 2' in lead
        assert all('[train]' not in out for _, out, _ in results[1:])


def test_cli_trains_on_the_cpu_only_when_asked(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.models.train',
           '--model', 'debug', '--steps', '2', '--log-every', '1',
           '--seq-len', '32']
    text = tmp_path / 'corpus.txt'
    text.write_text('a b c d e f g h i j k l m n o p\n' * 20)
    data = str(tmp_path / 'corpus.bin')
    jdata.encode_text(str(text), data, 256)
    ckpt_dir = str(tmp_path / 'ckpt')
    out = subprocess.run(cmd + ['--device', 'cpu', '--checkpoint-dir',
                                ckpt_dir, '--data', data], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert '[train] step 2/2 loss=' in out.stdout
    assert '[train] done at step 2' in out.stdout
    assert tckpt.list_steps(ckpt_dir) == [2]
    if torch.cuda.is_available():
        return
    out = subprocess.run(cmd, cwd=REPO_ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
