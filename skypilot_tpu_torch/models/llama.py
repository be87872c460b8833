"""Llama-3-family decoder in plain PyTorch: forward and training loss.

Counterpart of ``skypilot_tpu/models/llama.py``. The parameter layout is
the reference's, so weights bridge by plain copy
(``models/convert.py``): a dict with ``tok_embedding [V, D]``,
``layers`` (each weight stacked ``[L, in, out]`` and applied as
``x @ W``), ``out_norm [D]`` and ``lm_head [D, V]``.

Numerics follow the reference step for step: bf16 activations, RMSNorm
statistics in fp32 cast to the model dtype *before* the weight multiply,
split-half RoPE in fp32, SwiGLU in fp32 cast before ``w2``, and the
lm_head product in the model dtype *then* cast to fp32.

The seven per-layer weight GEMMs go through :func:`quant_mm` /
:func:`quant_mms`, which run int8 weights (``ops/quant.QuantizedTensor``,
made by ``decode.quantize_params`` for serving) on the int8 GEMM and a
plain tensor as ``x @ w``; ``lm_head`` and the embedding stay in the
model dtype, as in the reference.

Training: :func:`loss_fn` (mean next-token cross-entropy, optionally in
checkpointed sequence chunks), per-block rematerialisation through
``torch.utils.checkpoint`` under the reference's five policies (see
:func:`remat_block`), and the flash-attention kernels of
``ops/flash_attention.py`` when ``flash_attention`` is set — for prefill
too, as in the reference. ``impl`` ('kernel' or 'plain')
picks the flash kernels or their plain twins; None takes the kernels on
CUDA tensors.

On a training mesh (``parallel/mesh.Mesh``, the ``mesh=`` argument of
:func:`forward_hidden` and :func:`loss_fn`) every rank holds its slices
under :func:`param_partition_specs` and runs the same program on its
rows of the batch: each block all-gathers its weights' fsdp slices
inside the remat region (so the recompute gathers them again), attention
runs on the rank's ``H/model`` query and ``Hkv/model`` KV heads, the
row-parallel wo/w2 products are summed over 'model', the embedding
lookup and the cross-entropy are vocab-parallel (a distributed
logsumexp and gold logit, as the reference's compiled program does),
and the loss is this rank's share of the global mean.
"""
import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import CheckpointPolicy
from torch.utils.checkpoint import checkpoint
from torch.utils.checkpoint import create_selective_checkpoint_contexts

from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import flash_attention as flash_ops
from skypilot_tpu_torch.ops import quant
from skypilot_tpu_torch.parallel import mesh as mesh_lib

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # Remat each block's activations (trade FLOPs for device memory).
    remat: bool = True
    # What backward keeps of a block (REMAT_POLICIES): 'full' only its
    # input; 'dots' also the wq/wk/wv/wo/w1/w3 outputs; 'ffn' the w1 and
    # w3 outputs; 'ffn1' the w1 output; 'attn' the attention output.
    remat_policy: str = 'full'
    # Ring attention over the 'seq' axis of a caller's sequence-sharded
    # context (parallel/ring.py). The trainer has none, so a loss or a
    # train loop with it set raises, as the reference's does.
    ring_attention: bool = False
    # Causal attention through the flash kernels (training and prefill).
    flash_attention: bool = False
    # Cross-entropy in this many checkpointed sequence chunks, so the
    # [B, S, vocab] logits never exist at once (1 = unchunked).
    ce_chunks: int = 1

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def num_params(self) -> int:
        emb = self.vocab_size * self.dim
        per_layer = (
            self.dim * self.n_heads * self.head_dim +
            2 * self.dim * self.n_kv_heads * self.head_dim +
            self.n_heads * self.head_dim * self.dim +
            3 * self.dim * self.ffn_dim +
            2 * self.dim)
        return 2 * emb + self.n_layers * per_layer + self.dim

    def flops_per_token(self, seq_len: int) -> float:
        """Approx fwd+bwd FLOPs per token (6N + attention term)."""
        n = self.num_params() - self.vocab_size * self.dim  # non-embedding
        attn = 12 * self.n_layers * self.dim * seq_len  # causal ~ s/2 * 2
        return 6 * n + attn


# The reference's published shapes and small test/bench configs.
CONFIGS: Dict[str, LlamaConfig] = {
    'llama3-8b': LlamaConfig(),
    'llama3-70b': LlamaConfig(dim=8192, n_layers=80, n_heads=64,
                              n_kv_heads=8, ffn_dim=28672),
    'llama3-1b': LlamaConfig(dim=2048, n_layers=16, n_heads=32,
                             n_kv_heads=8, ffn_dim=8192,
                             vocab_size=128256),
    'bench-160m': LlamaConfig(vocab_size=32768, dim=1024, n_layers=12,
                              n_heads=16, n_kv_heads=8, ffn_dim=4096,
                              max_seq_len=2048),
    'bench-1b': LlamaConfig(vocab_size=32768, dim=2048, n_layers=16,
                            n_heads=16, n_kv_heads=8, ffn_dim=8192,
                            max_seq_len=2048, ce_chunks=8),
    'bench-cpu': LlamaConfig(vocab_size=2048, dim=256, n_layers=3,
                             n_heads=4, n_kv_heads=2, ffn_dim=768,
                             max_seq_len=256, remat=False),
    'debug': LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                         remat=False),
}


# ------------------------------------------------------------------- init


def param_partition_specs(cfg: LlamaConfig) -> Params:
    """The training specs of the params (the reference's
    ``param_partition_specs``): contraction and head dims over 'model',
    the other dim over 'fsdp'; the layer-stacked tensors lead with None;
    norms replicate."""
    del cfg
    fsdp, model = mesh_lib.FSDP_AXIS, mesh_lib.MODEL_AXIS
    col = (None, fsdp, model)
    row = (None, model, fsdp)
    return {
        'tok_embedding': (model, fsdp),
        'layers': {
            'attn_norm': (None, None),
            'wq': col, 'wk': col, 'wv': col,
            'wo': row,
            'ffn_norm': (None, None),
            'w1': col, 'w3': col,
            'w2': row,
        },
        'out_norm': (None,),
        'lm_head': (fsdp, model),
    }


def param_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    """The param tree's shapes (same structure as the params)."""
    hd = cfg.head_dim
    L = cfg.n_layers
    return {
        'tok_embedding': (cfg.vocab_size, cfg.dim),
        'layers': {
            'attn_norm': (L, cfg.dim),
            'wq': (L, cfg.dim, cfg.n_heads * hd),
            'wk': (L, cfg.dim, cfg.n_kv_heads * hd),
            'wv': (L, cfg.dim, cfg.n_kv_heads * hd),
            'wo': (L, cfg.n_heads * hd, cfg.dim),
            'ffn_norm': (L, cfg.dim),
            'w1': (L, cfg.dim, cfg.ffn_dim),
            'w3': (L, cfg.dim, cfg.ffn_dim),
            'w2': (L, cfg.ffn_dim, cfg.dim),
        },
        'out_norm': (cfg.dim,),
        'lm_head': (cfg.dim, cfg.vocab_size),
    }


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device='cpu', mesh: Optional[mesh_lib.Mesh] = None,
                specs: Optional[Params] = None) -> Params:
    """Random params: normal(0, 0.02) in the model dtype from
    ``generator`` (which must live on ``device``), norms set to ones.
    Leaves are drawn in a fixed order, a layer-stacked one a layer at a
    time; with a ``mesh`` only this rank's slice of each draw under
    ``specs`` (default :func:`param_partition_specs`) is kept, a layer
    stack split on its layer dim keeping its layers. So one seed gives
    the same params at any mesh, and no rank holds more than one layer
    of a stacked leaf whole. Draws differ from the reference's
    ``jax.random`` stream; parity tests bridge the reference's own
    params instead."""
    return init_tree(param_shapes(cfg), specs or param_partition_specs(cfg),
                     lambda name: cfg.dtype, generator, device, mesh)


def init_tree(shapes: Params, specs: Params, dtype_of, generator,
              device, mesh: Optional[mesh_lib.Mesh]) -> Params:
    """:func:`init_params` over any tree of ``shapes`` (non-layer leaves
    first, then ``layers``, each in the tree's order), leaf ``name`` in
    ``dtype_of(name)``."""
    def draw(name, shape, spec):
        dtype = dtype_of(name)
        if name.endswith('norm'):
            w = torch.ones(shape, dtype=dtype, device=device)
        else:
            w = torch.empty(shape, dtype=torch.float32, device=device)
            w.normal_(0.0, 0.02, generator=generator)
            w = w.to(dtype)
        return w if mesh is None else mesh_lib.shard_tensor(w, spec, mesh)

    def stacked(name, shape, spec):
        keep = range(shape[0])
        if mesh is not None:
            keep = range(shape[0])[mesh_lib.spec_to_slices(
                shape[:1], spec[:1], mesh)[0]]
        out = None
        for i in range(shape[0]):
            w = draw(name, shape[1:], spec[1:])
            if i not in keep:
                continue
            if out is None:
                out = w.new_empty((len(keep),) + tuple(w.shape))
            out[i - keep.start] = w
        return out

    params = {name: draw(name, shape, specs[name])
              for name, shape in shapes.items() if name != 'layers'}
    params['layers'] = {name: stacked(name, shape, specs['layers'][name])
                        for name, shape in shapes['layers'].items()}
    return params


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked layer weights (views)."""
    return {name: w[i] for name, w in params['layers'].items()}


# ---------------------------------------------------------------- forward


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * weight


def _rope_freqs(cfg: LlamaConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    hd = cfg.head_dim
    exponent = (torch.arange(0, hd, 2, dtype=torch.float32,
                             device=positions.device) / hd)
    inv_freq = 1.0 / (cfg.rope_theta**exponent)
    angles = positions[..., None].float() * inv_freq     # [B?, S, hd/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd]; cos/sin [S, hd/2] or [B, S, hd/2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def qkv(cfg: LlamaConfig, x: torch.Tensor, layer: Params, cos: torch.Tensor,
        sin: torch.Tensor, mesh: Optional[mesh_lib.Mesh] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Norm → Q/K/V projections → RoPE: [B,S,H,hd], [B,S,Hkv,hd] x2."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = _model_in(rms_norm(x, layer['attn_norm'], cfg.norm_eps), mesh)
    q, k, v = quant_mms(h, layer['wq'], layer['wk'], layer['wv'])
    # The head counts come from the weights: a tensor-parallel rank's
    # wq/wk/wv hold its H/tp and Hkv/tp heads.
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _model_in(h: torch.Tensor, mesh: Optional[mesh_lib.Mesh]
              ) -> torch.Tensor:
    """The input of column-parallel products on a mesh (its grad summed
    over 'model'); unchanged without one."""
    return h if mesh is None else mesh_lib.copy_to_model(h, mesh)


def _model_out(y: torch.Tensor, mesh: Optional[mesh_lib.Mesh]
               ) -> torch.Tensor:
    """A row-parallel product summed over 'model' on a mesh."""
    return y if mesh is None else mesh_lib.reduce_from_model(y, mesh)


# The dim of each layer weight's per-layer slice that splits over fsdp.
_FSDP_DIM = {name: spec.index(mesh_lib.FSDP_AXIS) - 1
             for name, spec in param_partition_specs(None)['layers'].items()
             if mesh_lib.FSDP_AXIS in spec}


def _gathered(layer: Params, mesh: Optional[mesh_lib.Mesh],
              names) -> Params:
    """``layer`` with the weights ``names`` all-gathered over fsdp on a
    mesh (called inside the remat region, so the recompute gathers
    again); unchanged without one."""
    if mesh is None:
        return layer
    out = dict(layer)
    for n in names:
        out[n] = mesh_lib.gather_shards(layer[n], mesh, _FSDP_DIM[n])
    return out


def quant_mm(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul that dispatches on int8-quantized weights (the serving
    path, ``ops/quant.py``) and on tensor-parallel slices that carry a
    collective (``parallel/mesh.RowParallel``, ``VocabParallel``); a
    plain tensor is ``x @ w``. The reference's ``quant_mm``."""
    if isinstance(w, (mesh_lib.RowParallel, mesh_lib.VocabParallel)):
        return w.matmul(x)
    if isinstance(w, quant.QuantizedTensor):
        return quant.int8_matmul(x, w)
    return x @ w


def quant_mms(x: torch.Tensor, *ws) -> list:
    """``[quant_mm(x, w) for w in ws]``, quantising x's rows once when
    every weight is int8 (the same rows and scales as separate calls, so
    the same bits, in fewer launches)."""
    if all(isinstance(w, quant.QuantizedTensor) for w in ws):
        return quant.int8_matmuls(x, ws)
    return [quant_mm(x, w) for w in ws]


def full_sequence_attention(cfg: LlamaConfig, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor,
                            impl: Optional[str] = None,
                            seq_axis_sharded: bool = False,
                            mesh: Optional[mesh_lib.Mesh] = None
                            ) -> torch.Tensor:
    """The config-selected causal attention for full (non-cached)
    sequences: ring attention over ``mesh``'s 'seq' axis when the
    sequence is sharded over it (q/k/v this rank's shards), else flash
    kernels (or their twins, see ``impl``) when ``cfg.flash_attention``,
    else the grouped einsum. One place for the train, prefill and MoE
    paths."""
    if seq_axis_sharded:
        return attention_ops.ring_attention(q, k, v, mesh,
                                            mesh_lib.SEQ_AXIS)
    if cfg.flash_attention:
        return flash_ops.flash_attention(q, k, v, True, impl)
    return attention_ops.gqa_attention(q, k, v, causal=True)


def _attention_out(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
                   cos: torch.Tensor, sin: torch.Tensor,
                   impl: Optional[str],
                   mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """Norm → QKV → RoPE → causal attention: the attention output
    [B, S, H·hd] before ``wo`` (what the ``'attn'`` policy keeps)."""
    layer = _gathered(layer, mesh, ('wq', 'wk', 'wv'))
    return _attention(cfg, x, layer, cos, sin, impl, mesh)[0]


def _attention(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
               cos: torch.Tensor, sin: torch.Tensor, impl: Optional[str],
               mesh: Optional[mesh_lib.Mesh] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    q, k, v = qkv(cfg, x, layer, cos, sin, mesh)
    attn = full_sequence_attention(cfg, q, k, v, impl)
    return attn.reshape(b, s, -1), k, v


def attn_sublayer(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
                  cos: torch.Tensor, sin: torch.Tensor,
                  impl: Optional[str] = None,
                  mesh: Optional[mesh_lib.Mesh] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Norm → QKV → RoPE → causal attention → residual. Returns
    (x, k, v) so prefill seeds the KV cache from the same code."""
    attn, k, v = _attention(cfg, x, layer, cos, sin, impl, mesh)
    return _attn_residual(cfg, x, attn, layer, mesh), k, v


def _attn_residual(cfg: LlamaConfig, x: torch.Tensor, attn: torch.Tensor,
                   layer: Params,
                   mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    return x + _model_out(quant_mm(attn, layer['wo']), mesh).to(cfg.dtype)


def ffn_sublayer(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
                 mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """Norm → SwiGLU (fp32) → residual."""
    h = _model_in(rms_norm(x, layer['ffn_norm'], cfg.norm_eps), mesh)
    w1_out, w3_out = quant_mms(h, layer['w1'], layer['w3'])
    gate = torch.nn.functional.silu(w1_out.float())
    up = w3_out.float()
    down = quant_mm((gate * up).to(cfg.dtype), layer['w2'])
    return x + _model_out(down, mesh).to(cfg.dtype)


def _block(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
           cos: torch.Tensor, sin: torch.Tensor,
           impl: Optional[str],
           mesh: Optional[mesh_lib.Mesh] = None,
           saved: Optional['_SavedGemms'] = None) -> torch.Tensor:
    layer = _gathered(layer, mesh, _FSDP_DIM)
    if saved is not None:
        saved.mark(layer)
    x, _, _ = attn_sublayer(cfg, x, layer, cos, sin, impl, mesh)
    return ffn_sublayer(cfg, x, layer, mesh)


def _after_attention(cfg: LlamaConfig, x: torch.Tensor, attn: torch.Tensor,
                     layer: Params,
                     mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    layer = _gathered(layer, mesh, ('wo', 'w1', 'w3', 'w2'))
    return ffn_sublayer(cfg, _attn_residual(cfg, x, attn, layer, mesh),
                        layer, mesh)


REMAT_POLICIES = ('full', 'dots', 'ffn', 'ffn1', 'attn')
# The layer weights whose GEMM outputs a GEMM-saving policy keeps: what
# the reference's jax.checkpoint_policies keep and its backward reads.
# 'dots' (dots_with_no_batch_dims_saveable) leaves out w2, whose output
# the backward never reads, so XLA drops it; 'ffn' and 'ffn1' are
# save_only_these_names over the w1/w3 outputs.
SAVED_GEMMS = {'dots': ('wq', 'wk', 'wv', 'wo', 'w1', 'w3'),
               'ffn': ('w1', 'w3'),
               'ffn1': ('w1',)}


def check_remat(cfg: LlamaConfig) -> None:
    """Raise on a remat policy the reference does not have."""
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f'unknown remat_policy: {cfg.remat_policy!r} '
                         "(expected 'full', 'dots', 'ffn', 'ffn1' or 'attn')")


class _SavedGemms:
    """The weights whose products a selective policy keeps, as one pass
    of a checkpointed block holds them. The block marks them after its
    fsdp gather (:func:`_block`), in the forward and again in the
    recompute, so the policy finds the same GEMMs in both passes though
    a gather makes new tensors each time; the gathered weights
    themselves are never kept."""

    def __init__(self, names):
        self.names = tuple(names)
        self.storages = frozenset()

    def mark(self, layer: Params) -> None:
        self.storages = frozenset(layer[n].untyped_storage().data_ptr()
                                  for n in self.names)


def _saved_gemms_context(saved: _SavedGemms):
    """Selective-checkpoint contexts that keep the output of every
    ``aten.mm`` whose second operand lies in a storage ``saved`` marked
    (``x @ w`` on a [B, S, in] x reaches the dispatcher as an ``mm`` of
    its [B·S, in] fold; a row-parallel product's output is the rank's
    part, before the sum over 'model') and recompute everything else,
    the fsdp gathers and the 'model' sums included."""
    def policy(ctx, op, *args, **kwargs):
        del ctx, kwargs
        if (op is torch.ops.aten.mm.default and
                args[1].untyped_storage().data_ptr() in saved.storages):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def remat_block(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
                cos: torch.Tensor, sin: torch.Tensor,
                impl: Optional[str] = None,
                mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """One decoder block under ``torch.utils.checkpoint`` with
    ``cfg.remat_policy``. Backward keeps exactly the reference's
    residuals: the block input, plus the GEMM outputs of
    :data:`SAVED_GEMMS` (selective checkpointing) or, for ``'attn'``,
    the attention output (the block split at it into two checkpointed
    segments). Everything else is recomputed, the flash forward under
    every policy, as the reference recomputes it (it never keeps the
    LSE). The policies change memory and recompute, never values. On a
    mesh each segment gathers its weights inside, so the recompute
    gathers them again and the kept GEMM outputs are the rank's shard
    widths."""
    policy = cfg.remat_policy
    if policy == 'attn':
        attn = checkpoint(_attention_out, cfg, x, layer, cos, sin, impl,
                          mesh, use_reentrant=False)
        return checkpoint(_after_attention, cfg, x, attn, layer, mesh,
                          use_reentrant=False)
    saved, kwargs = None, {}
    if policy in SAVED_GEMMS:
        saved = _SavedGemms(SAVED_GEMMS[policy])
        kwargs['context_fn'] = functools.partial(_saved_gemms_context,
                                                 saved)
    return checkpoint(_block, cfg, x, layer, cos, sin, impl, mesh, saved,
                      use_reentrant=False, **kwargs)


def _embed(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
           mesh: Optional[mesh_lib.Mesh]) -> torch.Tensor:
    """The embedding lookup; on a mesh vocab-parallel: each rank looks up
    the tokens of its vocab rows (of its fsdp-gathered slice), zeros the
    rest, and the rows are summed over 'model'."""
    if mesh is None:
        return params['tok_embedding'][tokens.long()].to(cfg.dtype)
    table = mesh_lib.gather_shards(params['tok_embedding'], mesh, 1)
    rows = table.shape[0]
    local = tokens.long() - mesh.coord(mesh_lib.MODEL_AXIS) * rows
    inside = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
    return mesh_lib.reduce_from_model(x, mesh).to(cfg.dtype)


def check_no_ring(cfg: LlamaConfig) -> None:
    """Raise on ``cfg.ring_attention``: the whole-sequence paths give
    ring attention no sequence-sharded context (the reference's raise
    ``NameError: unbound axis name: seq`` there)."""
    if cfg.ring_attention:
        raise ValueError(
            "ring_attention needs a 'seq'-sharded context (unbound axis "
            "name: seq): call parallel/ring.ring_attention on the "
            "sequence shards; the trainer has none, as in the reference")


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                   positions: Optional[torch.Tensor] = None,
                   impl: Optional[str] = None,
                   mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """tokens [B, S] → final normed hidden states [B, S, dim].

    With ``cfg.remat`` and autograd on, each block runs under
    :func:`remat_block`. The stacked layer weights are unbound once, so
    their gradients come back as one stack instead of one full-size
    tensor per layer. On a ``mesh``: this rank's slices and rows (see
    the module's docstring)."""
    check_remat(cfg)
    check_no_ring(cfg)
    s = tokens.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)
    cos, sin = _rope_freqs(cfg, positions)
    x = _embed(params, tokens, cfg, mesh)
    names = sorted(params['layers'])
    per_layer = zip(*(params['layers'][n].unbind(0) for n in names))
    block = (remat_block if cfg.remat and torch.is_grad_enabled()
             else _block)
    for weights in per_layer:
        x = block(cfg, x, dict(zip(names, weights)), cos, sin, impl, mesh)
    return rms_norm(x, params['out_norm'], cfg.norm_eps)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, vocab] float32 (the lm_head
    product in the model dtype, then cast)."""
    x = forward_hidden(params, tokens, cfg, positions)
    return (x @ params['lm_head']).float()


# ------------------------------------------------------------------- loss


def _xent_from_logits(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Summed (not mean) next-token cross-entropy, fp32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None]).squeeze(-1)
    return (logz - gold).sum()


def _chunk_xent(x: torch.Tensor, lm_head: torch.Tensor,
                targets: torch.Tensor) -> torch.Tensor:
    return _xent_from_logits((x @ lm_head).float(), targets)


def chunked_cross_entropy(x: torch.Tensor, lm_head: torch.Tensor,
                          targets: torch.Tensor, num_chunks: int,
                          count: Optional[int] = None) -> torch.Tensor:
    """Mean CE over [B, S] without ever holding [B, S, vocab]: each
    sequence chunk's lm_head product and softmax run under
    ``checkpoint``, so backward recomputes the chunk's logits. Chunk
    sums add up in order, in fp32, as the reference's scan does. The sum
    is divided by ``count`` (default B·S: a share of a larger batch's
    mean otherwise)."""
    b, s, _ = x.shape
    if s % num_chunks:
        raise ValueError(f'seq_len {s} does not split into {num_chunks} '
                         'cross-entropy chunks')
    c = s // num_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(num_chunks):
        part = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_chunk_xent, x[:, part], lm_head,
                                   targets[:, part], use_reentrant=False)
    return total / (count or b * s)


class _VocabParallelXent(torch.autograd.Function):
    """Summed cross-entropy of vocab-sharded fp32 logits [..., V/model]:
    the logsumexp from the 'model' ranks' max and sum of exponentials,
    the gold logit from the rank whose columns hold the target. Backward:
    ``softmax - onehot`` on this rank's columns."""

    @staticmethod
    # pylint: disable-next=arguments-differ
    def forward(ctx, logits, targets, start, mesh):
        model = mesh_lib.MODEL_AXIS
        top = mesh.all_reduce(logits.max(dim=-1).values, model, 'max')
        sumexp = mesh.all_reduce(
            torch.exp(logits - top[..., None]).sum(dim=-1), model)
        lse = torch.log(sumexp) + top
        local = targets.long() - start
        inside = (local >= 0) & (local < logits.shape[-1])
        local = local.clamp(0, logits.shape[-1] - 1)
        gold = logits.gather(-1, local[..., None]).squeeze(-1) * inside
        gold = mesh.all_reduce(gold, model)
        ctx.save_for_backward(logits, lse, local, inside)
        return (lse - gold).sum()

    @staticmethod
    # pylint: disable-next=arguments-differ
    def backward(ctx, grad):
        logits, lse, local, inside = ctx.saved_tensors
        dlogits = torch.exp(logits - lse[..., None])
        dlogits.scatter_add_(-1, local[..., None],
                             -inside[..., None].to(dlogits.dtype))
        return dlogits * grad, None, None, None


def _chunk_xent_vocab_parallel(x: torch.Tensor, lm_head: torch.Tensor,
                               targets: torch.Tensor, start: int,
                               mesh: mesh_lib.Mesh) -> torch.Tensor:
    return _VocabParallelXent.apply((x @ lm_head).float(), targets, start,
                                    mesh)


def _sharded_xent(x: torch.Tensor, lm_head: torch.Tensor,
                  targets: torch.Tensor, cfg: LlamaConfig,
                  mesh: mesh_lib.Mesh) -> torch.Tensor:
    """This rank's share of the global mean CE: its rows' summed CE over
    the global token count, in ``cfg.ce_chunks`` checkpointed sequence
    chunks over the fsdp-gathered, vocab-sharded lm_head."""
    b, s, _ = x.shape
    if s % cfg.ce_chunks:
        raise ValueError(f'seq_len {s} does not split into '
                         f'{cfg.ce_chunks} cross-entropy chunks')
    lm = mesh_lib.gather_shards(lm_head, mesh, 0)
    start = mesh.coord(mesh_lib.MODEL_AXIS) * lm.shape[1]
    x = mesh_lib.copy_to_model(x, mesh)
    c = s // cfg.ce_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.ce_chunks):
        part = slice(i * c, (i + 1) * c)
        args = (x[:, part], lm, targets[:, part], start, mesh)
        total = total + (checkpoint(_chunk_xent_vocab_parallel, *args,
                                    use_reentrant=False)
                         if cfg.ce_chunks > 1 else
                         _chunk_xent_vocab_parallel(*args))
    return total / (b * s * mesh.size(mesh_lib.BATCH_AXES))


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: LlamaConfig, impl: Optional[str] = None,
            mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """Mean next-token cross-entropy (targets = tokens shifted by the
    caller), a scalar fp32 tensor. On a ``mesh``, ``tokens`` are this
    rank's rows and the result its share of the global batch's mean
    (the shares of the batch ranks sum to it)."""
    x = forward_hidden(params, tokens, cfg, impl=impl, mesh=mesh)
    if mesh is not None:
        return _sharded_xent(x, params['lm_head'], targets, cfg, mesh)
    if cfg.ce_chunks > 1:
        return chunked_cross_entropy(x, params['lm_head'], targets,
                                     cfg.ce_chunks)
    logits = (x @ params['lm_head']).float()
    return _xent_from_logits(logits, targets) / targets.numel()
