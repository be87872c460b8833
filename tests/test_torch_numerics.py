"""Where the port's bf16 numbers part from the JAX reference's, op by op
(``debug`` config, CPU, layer 0 of the prefill of one 29-token prompt).

Each op of layer 0 is fed the reference's own input and run by both
packages (the reference jitted, as it serves): every bf16 result is bit
for bit the same, though the fp32 transcendentals (exp, softmax, silu,
rsqrt, cos/sin) differ in their last bit. The one op that departs is
not an op of the source: XLA compiles the reference with
``xla_allow_excess_precision`` on, so inside one jit the FFN's RMSNorm
reads the attention residual unrounded, where the source (and the port)
rounds it to bf16. ``-s`` prints the counts that ROADMAP.md records.

A constant divisor is folded the same way: under ``jit``, ``a / 127``
is ``a * (1/127)``, which is why the port's activation quantisation
(``ops/quant._quantize_rows``) takes the reciprocal form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as tllama

torch.set_num_threads(2)

JCFG = jllama.CONFIGS['debug']
CFG = tllama.CONFIGS['debug']
S = 29


def _t(a) -> torch.Tensor:
    return convert.tensor_from_numpy(np.asarray(a))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().contiguous()
        a = a.view({2: torch.int16, 4: torch.int32}[a.element_size()])
        return a.numpy().astype(np.int64)
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({2: np.int16, 4: np.int32}[a.itemsize]).astype(np.int64)


def _differ(ref, got, name) -> int:
    """Values whose bits differ (printed with the most ulps apart)."""
    d = np.abs(_bits(ref) - _bits(got))
    n = int((d > 0).sum())
    print(f'{name}: {n} of {d.size} differ, at most {int(d.max())} ulps')
    return n


@pytest.fixture(scope='module')
def layer0():
    """Layer 0's weights in both packages, the prompt's embeddings and
    the reference's RoPE tables, fed to both sides."""
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), CFG)
    tok = np.random.RandomState(5).randint(0, CFG.vocab_size, (1, S))
    x = jp['tok_embedding'][tok].astype(JCFG.dtype)
    cos, sin = jax.jit(lambda p: jllama._rope_freqs(JCFG, p))(  # pylint: disable=protected-access
        jnp.arange(S, dtype=jnp.int32))
    jl = {k: v[0] for k, v in jp['layers'].items()}
    return jl, tllama.layer_params(tp, 0), x, cos, sin


def _mm(h, w):
    return jax.jit(lambda a, b: a @ b)(h, w)


def _attention_inputs(layer0):
    jl, _, x, cos, sin = layer0
    hd, b = JCFG.head_dim, 1
    h = jax.jit(lambda x, w: jllama.rms_norm(x, w, JCFG.norm_eps))(
        x, jl['attn_norm'])
    q = _mm(h, jl['wq']).reshape(b, S, JCFG.n_heads, hd)
    k = _mm(h, jl['wk']).reshape(b, S, JCFG.n_kv_heads, hd)
    v = _mm(h, jl['wv']).reshape(b, S, JCFG.n_kv_heads, hd)
    rope = jax.jit(jllama.apply_rope)
    return rope(q, cos, sin), rope(k, cos, sin), v


def _attention_probs(q, k):
    """The reference's gqa_attention up to the fp32 probabilities."""
    hd, g = JCFG.head_dim, JCFG.n_heads // JCFG.n_kv_heads

    def f(q, k):
        qg = q.reshape(1, S, JCFG.n_kv_heads, g, hd)
        logits = jnp.einsum('bskgd,btkd->bkgst', qg, k,
                            preferred_element_type=jnp.float32) * hd**-0.5
        mask = jnp.arange(S)[:, None] >= jnp.arange(S)[None, :]
        logits = jnp.where(mask[None, None, None], logits, -1e30)
        return logits, jax.nn.softmax(logits, axis=-1)

    return jax.jit(f)(q, k)


def _port_logits(q, k):
    hd, g = CFG.head_dim, CFG.n_heads // CFG.n_kv_heads
    qg = _t(q).reshape(1, S, CFG.n_kv_heads, g, hd).float()
    logits = torch.einsum('bskgd,btkd->bkgst', qg, _t(k).float()) * hd**-0.5
    mask = torch.arange(S)[:, None] >= torch.arange(S)[None, :]
    return torch.where(mask, logits, -1e30)


OPS = ['attn_norm', 'wq', 'rope_q', 'rope_k', 'probs', 'pv', 'wo',
       'residual', 'ffn_norm', 'w1', 'swiglu', 'w2']


@pytest.mark.parametrize('op', OPS)
def test_layer0_op_gives_the_reference_bf16_bits(layer0, op):
    """Each op of layer 0, fed the reference's input: the port's bf16
    result equals the reference's jitted one bit for bit."""
    jl, tl, x, cos, sin = layer0
    hd = CFG.head_dim
    q, k, v = _attention_inputs(layer0)
    logits, probs32 = _attention_probs(q, k)
    probs = probs32.astype(jnp.bfloat16)
    attn = jax.jit(lambda p, v: jnp.einsum(
        'bkgst,btkd->bskgd', p, v, preferred_element_type=jnp.float32
    ).reshape(1, S, -1).astype(jnp.bfloat16))(probs, v)
    wo = _mm(attn, jl['wo'])
    x1 = jax.jit(lambda x, o: x + o)(x, wo)
    norm = jax.jit(lambda x, w: jllama.rms_norm(x, w, JCFG.norm_eps))
    h2 = norm(x1, jl['ffn_norm'])
    w1, w3 = _mm(h2, jl['w1']), _mm(h2, jl['w3'])
    act = jax.jit(lambda a, b: (jax.nn.silu(a.astype(jnp.float32)) *
                                b.astype(jnp.float32)).astype(JCFG.dtype))
    if op == 'attn_norm':
        ref = norm(x, jl['attn_norm'])
        got = tllama.rms_norm(_t(x), tl['attn_norm'], CFG.norm_eps)
    elif op == 'wq':
        ref = _mm(norm(x, jl['attn_norm']), jl['wq'])
        got = _t(norm(x, jl['attn_norm'])) @ tl['wq']
    elif op in ('rope_q', 'rope_k'):
        heads = CFG.n_heads if op == 'rope_q' else CFG.n_kv_heads
        w = jl['wq' if op == 'rope_q' else 'wk']
        raw = _mm(norm(x, jl['attn_norm']), w).reshape(1, S, heads, hd)
        ref = q if op == 'rope_q' else k
        got = tllama.apply_rope(_t(raw), _t(cos), _t(sin))
    elif op == 'probs':
        _differ(logits, _port_logits(q, k), 'attention logits (fp32)')
        _differ(probs32, torch.softmax(_t(logits), -1),
                'softmax of the same logits (fp32)')
        ref = probs
        got = torch.softmax(_t(logits), -1).to(torch.bfloat16)
    elif op == 'pv':
        ref = attn
        got = torch.einsum('bkgst,btkd->bskgd', _t(probs).float(),
                           _t(v).float()).reshape(1, S, -1).to(
                               torch.bfloat16)
    elif op == 'wo':
        ref, got = wo, _t(attn) @ tl['wo']
    elif op == 'residual':
        ref, got = x1, _t(x) + _t(wo)
    elif op == 'ffn_norm':
        ref = h2
        got = tllama.rms_norm(_t(x1), tl['ffn_norm'], CFG.norm_eps)
    elif op == 'w1':
        ref, got = w1, _t(h2) @ tl['w1']
    elif op == 'swiglu':
        _differ(jax.jit(lambda a: jax.nn.silu(a.astype(jnp.float32)))(w1),
                torch.nn.functional.silu(_t(w1).float()),
                'silu of the same input (fp32)')
        ref = act(w1, w3)
        got = (torch.nn.functional.silu(_t(w1).float()) *
               _t(w3).float()).to(torch.bfloat16)
    else:
        ref, got = _mm(act(w1, w3), jl['w2']), _t(act(w1, w3)) @ tl['w2']
    assert _differ(ref, got, f'{op} (bf16)') == 0


def test_fused_reference_norms_the_unrounded_residual(layer0):
    """One jit over the attention sublayer and the FFN's RMSNorm (as the
    reference's prefill compiles it): its norm is the port's norm of
    ``x + attn @ wo`` kept in fp32, not of the bf16-rounded sum that
    the source writes and the port computes."""
    jl, tl, x, cos, sin = layer0
    fused = jax.jit(lambda x, l: jllama.rms_norm(
        jllama.attn_sublayer(JCFG, x, l, cos, sin)[0], l['ffn_norm'],
        JCFG.norm_eps))(x, jl)
    q, k, v = tllama.qkv(CFG, _t(x), tl, _t(cos), _t(sin))
    attn = tllama.full_sequence_attention(CFG, q, k, v).reshape(1, S, -1)
    wo = attn @ tl['wo']
    rounded = _t(x) + wo
    unrounded = _t(x).float() + wo.float()
    rms = torch.rsqrt((unrounded * unrounded).mean(-1, keepdim=True) +
                      CFG.norm_eps)
    excess = (unrounded * rms).to(CFG.dtype) * tl['ffn_norm']
    assert _differ(fused, excess, 'fused norm vs the unrounded residual') == 0
    assert _differ(fused, tllama.rms_norm(rounded, tl['ffn_norm'],
                                          CFG.norm_eps),
                   'fused norm vs the rounded residual (bf16)') > 0


@pytest.mark.parametrize('name', ['exp', 'silu', 'rsqrt', 'softmax'])
def test_transcendentals_differ_only_in_the_last_bits(name):
    """The same fp32 inputs (262,144 draws of N(0, 1)) through XLA:CPU
    and torch on the CPU: the results differ in a few ulps at most,
    never beyond."""
    z = np.random.RandomState(0).randn(262144).astype(np.float32)
    jf, tf = {
        'exp': (jnp.exp, torch.exp),
        'silu': (jax.nn.silu, torch.nn.functional.silu),
        'rsqrt': (lambda a: jax.lax.rsqrt(jnp.abs(a) + 1e-3),
                  lambda a: torch.rsqrt(a.abs() + 1e-3)),
        'softmax': (lambda a: jax.nn.softmax(a.reshape(-1, 512), -1),
                    lambda a: torch.softmax(a.reshape(-1, 512), -1)),
    }[name]
    ref = jax.jit(jf)(z)
    got = tf(torch.from_numpy(z))
    _differ(ref, got, f'{name} (fp32)')
    assert np.abs(_bits(ref) - _bits(got)).max() <= 8


def test_jit_folds_a_constant_divisor_into_its_reciprocal():
    """Under jit XLA computes ``a / 127`` as ``a * (1/127)``: bit for bit
    the reciprocal form, which eager division misses in some values."""
    a = np.abs(np.random.RandomState(0).randn(100000)).astype(np.float32)
    folded = np.asarray(jax.jit(lambda a: a / 127.0)(a))
    np.testing.assert_array_equal(
        _bits(folded), _bits(torch.from_numpy(a) * (1.0 / 127.0)))
    assert _differ(folded, torch.from_numpy(a) / 127.0,
                   'a / 127 under jit vs divided') > 0


def test_rope_tables_differ_without_moving_the_bf16_rotation(layer0):
    """The port's RoPE tables (torch's pow, cos, sin) against the
    reference's (XLA folds the constant frequencies): the fp32 tables
    differ, and layer 0's rotated q and k stay bit for bit equal."""
    jl, tl, x, cos, sin = layer0
    tcos, tsin = tllama._rope_freqs(  # pylint: disable=protected-access
        CFG, torch.arange(S, dtype=torch.int32))
    _differ(cos, tcos, 'rope cos table (fp32)')
    _differ(sin, tsin, 'rope sin table (fp32)')
    q, k, _ = _attention_inputs(layer0)
    tq, tk, _ = tllama.qkv(CFG, _t(x), tl, tcos, tsin)
    assert _differ(q, tq, 'q rotated by each side\'s tables (bf16)') == 0
    assert _differ(k, tk, 'k rotated by each side\'s tables (bf16)') == 0
