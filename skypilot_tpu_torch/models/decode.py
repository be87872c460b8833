"""Batched autoregressive inference: prefill + KV-cache decode, dense and
paged.

Counterpart of ``skypilot_tpu/models/decode.py``, same semantics:

* Dense cache ``{'k','v'} [L, B, max_len, Hkv, hd]`` (+ fp32
  ``{'k_scale','v_scale'} [L, B, max_len, Hkv]`` when int8), or a paged
  block pool ``[L, n_blocks, block_k, Hkv, hd]`` whose block 0 the
  engine keeps as scratch; a sequence's position ``p`` lives in pool
  block ``table[p // block_k]`` at offset ``p % block_k``.
* Prefill runs the full forward once (plain GQA attention) and writes
  the cache; each decode step writes the new token's K/V, then attends
  over the cache through ``ops/decode_attention`` — the CUDA kernels on
  the card, their plain twins on the CPU or under
  ``decode_attention='plain'``.
* The reference donates its cache to every jitted call so XLA updates it
  in place; here the cache tensors are simply updated in place (every
  ``_write_kv``/``copy_block`` below), so callers keep one cache object
  for the life of the engine, and the engine's CUDA graphs
  (``models/cuda_graphs.py``) are captured over it. The paged prefills
  take their lengths as 0-d tensors too, and nothing here reads a device
  value back to the host, so a captured call serves every length.
* Greedy or temperature sampling; ``generate`` stops per sequence on EOS
  through a done mask. On the card ``generate`` runs as CUDA graphs of a
  :class:`GenerateProgram` kept per key, the counterpart of the
  reference's jitted ``_generate_impl`` (``rounds='eager'``: the same
  steps one by one).
* Int8 weights (:func:`quantize_params`): the seven per-layer GEMM
  weights become ``ops/quant.QuantizedTensor``s, which ``llama.quant_mm``
  routes to the int8 GEMM; every path below reaches them through
  ``llama.qkv``, ``_attend_out`` and ``llama.ffn_sublayer``.
* Speculative decoding (paged, greedy): :func:`spec_draft_tokens` drafts
  ``spec_k`` tokens with the model's first layers, reading the pool and
  never writing it; :func:`paged_verify_step` scores the last token and
  the drafts in one S-token step through the verify kernel
  (``ops/decode_attention.paged_verify_attention``).
"""
import collections
import dataclasses
import functools
import itertools
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models import cuda_graphs, llama
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.observability import runtime_metrics
from skypilot_tpu_torch.ops import decode_attention as decode_attention_ops
from skypilot_tpu_torch.ops import quant

Params = llama.Params
Cache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    max_len: int = 2048
    temperature: float = 0.0          # 0 = greedy
    eos_id: Optional[int] = None
    # Cached attention: 'kernel' = the CUDA flash-decode kernels (plain
    # twins for CPU tensors); 'plain' = the plain PyTorch path everywhere
    # (the reference's 'xla').
    decode_attention: str = 'kernel'
    # KV cache storage: 'bf16' (model dtype) or 'int8' (+ fp32 scales).
    kv_cache_dtype: str = 'bf16'
    # Paged pool block size in tokens.
    kernel_block_k: int = decode_attention_ops.DEFAULT_BLOCK_K
    # Speculative decoding (paged engine only, greedy): a truncated-layer
    # drafter proposes spec_k tokens per engine step and one batched
    # multi-token verify scores them against the full model. 0 disables.
    spec_k: int = 0
    # The drafter is the served model's first N decoder layers plus its
    # out-norm + lm_head (no second set of weights); its attention reads
    # the pool blocks the full model wrote.
    spec_drafter_layers: int = 1


# The per-layer GEMM weights that ``quantize_params`` makes int8.
QUANTIZED_WEIGHTS = ('w1', 'w3', 'w2', 'wq', 'wk', 'wv', 'wo')


def quantize_params(params: Params) -> Params:
    """Int8-quantize the per-layer GEMM weights (FFN and attention
    projections) for serving. Layer weights are stacked [L, in, out]:
    the contraction axis is 1, so scales are per (layer, output
    channel), [L, 1, out]. Embedding, norms and lm_head stay in the
    model dtype; the KV cache quantizes separately
    (``DecodeConfig.kv_cache_dtype``). One layer at a time, which gives
    the same bits as the whole stack at once (the scales never span
    layers) without llama3-8b's 7.5 GB fp32 transient of a stacked
    ``w1``. Counterpart of the reference's ``quantize_params``."""
    out = dict(params)
    layers = dict(params['layers'])
    for name in QUANTIZED_WEIGHTS:
        w = layers[name]
        n_layers, k, n = w.shape
        # K-major storage (ops/quant.k_major), shape [L, K, N].
        values = torch.empty((n_layers, n, k), dtype=torch.int8,
                             device=w.device).transpose(1, 2)
        scale = torch.empty((n_layers, 1, n), dtype=torch.float32,
                            device=w.device)
        for i in range(n_layers):
            qw = quant.quantize_int8(w[i], axis=0)
            values[i] = qw.values
            scale[i] = qw.scale
        layers[name] = quant.QuantizedTensor(values=values, scale=scale)
    out['layers'] = layers
    return out


def _empty_cache(cfg: llama.LlamaConfig, shape, kv_cache_dtype: str,
                 device) -> Cache:
    if kv_cache_dtype == 'int8':
        return {
            'k': torch.zeros(shape, dtype=torch.int8, device=device),
            'v': torch.zeros(shape, dtype=torch.int8, device=device),
            'k_scale': torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
            'v_scale': torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
        }
    if kv_cache_dtype != 'bf16':
        raise ValueError(f'kv_cache_dtype must be bf16 or int8, got '
                         f'{kv_cache_dtype!r}')
    return {'k': torch.zeros(shape, dtype=cfg.dtype, device=device),
            'v': torch.zeros(shape, dtype=cfg.dtype, device=device)}


def init_kv_cache(cfg: llama.LlamaConfig, batch: int, max_len: int,
                  kv_cache_dtype: str = 'bf16', device='cpu') -> Cache:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return _empty_cache(cfg, shape, kv_cache_dtype, device)


def init_block_pool(cfg: llama.LlamaConfig, num_blocks: int, block_k: int,
                    kv_cache_dtype: str = 'bf16', device='cpu',
                    tp: int = 1) -> Cache:
    """Global paged pool [L, num_blocks, block_k, Hkv, hd] (+ scale
    planes when int8). Block 0 is the engine's write-off scratch block,
    so usable capacity is ``num_blocks - 1`` blocks. A tensor-parallel
    rank's pool holds its ``Hkv / tp`` heads (``parallel/mesh.
    kv_cache_spec``)."""
    shape = (cfg.n_layers, num_blocks, block_k, cfg.n_kv_heads // tp,
             cfg.head_dim)
    return _empty_cache(cfg, shape, kv_cache_dtype, device)


def _layer_cache(cache: Cache, i: int) -> Cache:
    return {name: t[i] for name, t in cache.items()}


def _kv_planes(cache: Cache, k: torch.Tensor, v: torch.Tensor) -> Cache:
    """K/V as the cache stores them, by plane name: quantised (values and
    scales) when the cache is int8 — the one copy of the write-side
    scheme, shared by prefill and decode."""
    if 'k_scale' in cache:
        kq, ks = quant.quantize_kv(k)
        vq, vs = quant.quantize_kv(v)
        return {'k': kq, 'v': vq, 'k_scale': ks, 'v_scale': vs}
    return {'k': k.to(cache['k'].dtype), 'v': v.to(cache['v'].dtype)}


def _write_kv(cache: Cache, idx, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write K/V into ``cache[...]`` at ``idx`` in place (the reference
    returns a donated copy)."""
    for name, value in _kv_planes(cache, k, v).items():
        cache[name][idx] = value


def _logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final hidden rows → fp32 logits (lm_head in the model dtype; a
    tensor-parallel rank's vocab slice gathers the whole row)."""
    return llama.quant_mm(x, params['lm_head']).float()


def _embed(params: Params, tokens: torch.Tensor,
           cfg: llama.LlamaConfig) -> torch.Tensor:
    return params['tok_embedding'][tokens.long()].to(cfg.dtype)


def _attend_out(cfg: llama.LlamaConfig, x: torch.Tensor,
                attn: torch.Tensor, layer: Params) -> torch.Tensor:
    """Attention output projection + residual, then the FFN sublayer."""
    b, s = x.shape[:2]
    attn = attn.reshape(b, s, -1)
    x = x + llama.quant_mm(attn, layer['wo']).to(cfg.dtype)
    return llama.ffn_sublayer(cfg, x, layer)


# ------------------------------------------------------------------ dense


def _decode_layers(params: Params, token: torch.Tensor, pos: torch.Tensor,
                   cfg: llama.LlamaConfig, dcfg: DecodeConfig,
                   cache: Cache, write_idx,
                   block_tables: Optional[torch.Tensor]) -> torch.Tensor:
    """The single-token step shared by the dense and paged caches: per
    layer, write the new K/V at ``write_idx`` (quantising when int8),
    then attend over positions < pos + 1 — through the block tables when
    given. Returns logits [B, vocab]."""
    cos, sin = llama._rope_freqs(cfg, pos[:, None])  # pylint: disable=protected-access
    x = _embed(params, token, cfg)[:, None]
    cur_len = (pos + 1).to(torch.int32)
    for i in range(cfg.n_layers):
        layer = llama.layer_params(params, i)
        lcache = _layer_cache(cache, i)
        q, k, v = llama.qkv(cfg, x, layer, cos, sin)
        _write_kv(lcache, write_idx, k[:, 0], v[:, 0])
        scales = (lcache.get('k_scale'), lcache.get('v_scale'))
        if block_tables is None:
            attn = decode_attention_ops.decode_attention(
                q, lcache['k'], lcache['v'], cur_len, *scales,
                impl=dcfg.decode_attention)
        else:
            attn = decode_attention_ops.paged_decode_attention(
                q, lcache['k'], lcache['v'], block_tables, cur_len,
                *scales, impl=dcfg.decode_attention)
        x = _attend_out(cfg, x, attn, layer)
    x = llama.rms_norm(x, params['out_norm'], cfg.norm_eps)
    return _logits(params, x[:, 0])


def decode_step(params: Params, token: torch.Tensor, pos: torch.Tensor,
                cfg: llama.LlamaConfig, dcfg: DecodeConfig,
                cache: Cache) -> torch.Tensor:
    """token [B] at positions pos [B] → logits [B, vocab]; the dense cache
    is updated in place at (row, pos). Counterpart of the reference's
    ``_decode_step``/``_block_decode``."""
    pos = pos.long()
    rows = torch.arange(pos.shape[0], device=pos.device)
    return _decode_layers(params, token, pos, cfg, dcfg, cache,
                          (rows, pos), None)


def _prefill_forward(params: Params, tokens: torch.Tensor,
                     cfg: llama.LlamaConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens [B, S] → (final normed hidden [B, S, D], ks, vs [L, B, S,
    Hkv, hd]). Causal, so a prompt's activations are the same alone in
    a [1, S_bucket] bucket as in a [B, S] batch. Callers take the
    logits of only the rows they need."""
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    cos, sin = llama._rope_freqs(cfg, positions)  # pylint: disable=protected-access
    x = _embed(params, tokens, cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        layer = llama.layer_params(params, i)
        x, k, v = llama.attn_sublayer(cfg, x, layer, cos, sin)
        x = llama.ffn_sublayer(cfg, x, layer)
        ks.append(k)
        vs.append(v)
    x = llama.rms_norm(x, params['out_norm'], cfg.norm_eps)
    return x, torch.stack(ks), torch.stack(vs)


def prefill(params: Params, tokens: torch.Tensor, cfg: llama.LlamaConfig,
            cache: Cache, prompt_lens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S_prompt] right-padded → logits at each sequence's
    last prompt token [B, vocab]; writes the cache prefix in place."""
    b, s = tokens.shape
    x, ks, vs = _prefill_forward(params, tokens, cfg)
    _write_kv(cache, (slice(None), slice(None), slice(0, s)), ks, vs)
    rows = torch.arange(b, device=tokens.device)
    return _logits(params, x[rows, prompt_lens.long() - 1])


# ------------------------------------------------------------------ paged


def paged_decode_step(params: Params, token: torch.Tensor,
                      pos: torch.Tensor, block_tables: torch.Tensor,
                      cfg: llama.LlamaConfig, dcfg: DecodeConfig,
                      pool: Cache) -> torch.Tensor:
    """token [B] at positions pos [B], tables [B, max_blocks] → logits
    [B, vocab]; the K/V write goes to (table[pos // block_k], pos %
    block_k) of the pool, in place. Counterpart of the reference's
    ``_paged_decode_step``/``_paged_block_decode``."""
    pos = pos.long()
    block_k = pool['k'].shape[2]
    blk = block_tables.long().gather(1, (pos // block_k)[:, None])[:, 0]
    tables = block_tables.to(torch.int32)
    return _decode_layers(params, token, pos, cfg, dcfg, pool,
                          (blk, pos % block_k), tables)


def _length(n, device) -> torch.Tensor:
    """A prefill length (or lane) as a 0-d integer tensor on ``device``:
    the engine passes its static buffers' (a captured prefill reads the
    length from there), other callers may pass an int."""
    return torch.as_tensor(n, device=device)


def _row_at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a 0-d tensor) of ``x`` [S, D]: a gather on the device,
    where ``x[i]`` would read ``i`` back to the host."""
    return x.index_select(0, i.reshape(1))[0]


def prefill_into_slot(params: Params, tokens: torch.Tensor, prompt_len,
                      slot, cfg: llama.LlamaConfig,
                      cache: Cache) -> torch.Tensor:
    """Prefill ONE request ([1, S_bucket] right-padded) into lane
    ``slot`` of a multi-slot cache, positions [0, S_bucket); other lanes
    are untouched. ``prompt_len`` and ``slot`` are ints or 0-d integer
    tensors (the engine's static buffers): the lane write is an indexed
    copy and the last row a gather, so nothing reads them back to the
    host and one captured call serves every length and lane of its
    bucket. Returns the last prompt token's logits [vocab]."""
    s = tokens.shape[1]
    device = tokens.device
    lane = _length(slot, device).reshape(1).long()
    x, ks, vs = _prefill_forward(params, tokens, cfg)
    for name, value in _kv_planes(cache, ks[:, 0], vs[:, 0]).items():
        cache[name].narrow(2, 0, s).index_copy_(1, lane, value[:, None])
    return _logits(params, _row_at(x[0], _length(prompt_len, device) - 1))


def paged_prefill(params: Params, tokens: torch.Tensor,
                  prompt_len, block_row: torch.Tensor,
                  cfg: llama.LlamaConfig, pool: Cache) -> torch.Tensor:
    """Prefill ONE request into the pool blocks named by ``block_row``
    [S_bucket // block_k]: positions [j*block_k, (j+1)*block_k) land in
    block ``block_row[j]``. Bucket padding writes into whatever block
    covers it (the engine points rows past the allocation at scratch;
    attention masks by length). ``prompt_len`` is an int or a 0-d
    integer tensor. Returns the last prompt logits."""
    s = tokens.shape[1]
    block_k = pool['k'].shape[2]
    prompt_len = _length(prompt_len, tokens.device)
    x, ks, vs = _prefill_forward(params, tokens, cfg)
    shp = (ks.shape[0], s // block_k, block_k) + ks.shape[3:]
    _write_kv(pool, (slice(None), block_row.long()),
              ks[:, 0].reshape(shp), vs[:, 0].reshape(shp))
    return _logits(params, _row_at(x[0], prompt_len - 1))


def _prefix_suffix_attention(q: torch.Tensor, pk: torch.Tensor,
                             pv: torch.Tensor, sk: torch.Tensor,
                             sv: torch.Tensor,
                             prefix_len: torch.Tensor) -> torch.Tensor:
    """Suffix queries attend the gathered prefix K/V (positions <
    prefix_len) plus the suffix itself (causal). q/sk/sv [1, S, ...],
    pk/pv [1, P_buf, Hkv, hd]; grouped GQA einsum."""
    _, s, h, hd = q.shape
    p_buf = pk.shape[1]
    hkv = pk.shape[2]
    g = h // hkv
    k = torch.cat([pk, sk], dim=1)
    v = torch.cat([pv, sv], dim=1)
    qg = q.reshape(1, s, hkv, g, hd)
    logits = torch.einsum('bskgd,btkd->bkgst', qg.float(),
                          k.float()) * hd**-0.5
    t_idx = torch.arange(p_buf + s, device=q.device)[None, :]
    j_idx = torch.arange(s, device=q.device)[:, None]
    # [S, P_buf + S]: prefix entries gate on prefix_len, suffix causal.
    mask = torch.where(t_idx < p_buf, t_idx < prefix_len,
                       (t_idx - p_buf) <= j_idx)
    logits = torch.where(mask, logits, decode_attention_ops.NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum('bkgst,btkd->bskgd', probs.float(), v.float())
    return out.reshape(1, s, h, hd).to(q.dtype)


def _gather_prefix_kv(pool: Cache, prefix_blocks: torch.Tensor,
                      dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pool → contiguous prefix K/V [L, Npb*block_k, Hkv, hd] (int8
    pools dequantise here; the suffix forward runs in model dtype)."""
    block_k = pool['k'].shape[2]
    idx = prefix_blocks.long()

    def flat(x):
        g = x[:, idx]                          # [L, Npb, block_k, ...]
        return g.reshape((x.shape[0], idx.shape[0] * block_k) +
                         x.shape[3:])

    pk, pv = flat(pool['k']), flat(pool['v'])
    if 'k_scale' in pool:
        pk = pk.float() * flat(pool['k_scale'])[..., None]
        pv = pv.float() * flat(pool['v_scale'])[..., None]
    return pk.to(dtype), pv.to(dtype)


def paged_prefill_with_prefix(params: Params, tokens: torch.Tensor,
                              suffix_len, prefix_len,
                              prefix_blocks: torch.Tensor,
                              block_row: torch.Tensor,
                              cfg: llama.LlamaConfig,
                              pool: Cache) -> torch.Tensor:
    """Prefix-skipping prefill: only the prompt suffix (``tokens`` [1,
    S_bucket], right-padded) runs through the model, attending over the
    prefix K/V already in the pool blocks ``prefix_blocks`` (padded
    entries masked by ``prefix_len``). ``block_row`` [S_bucket // block_k
    + 1] names the blocks receiving the suffix writes, starting at the
    block holding position ``prefix_len``. The lengths are ints or 0-d
    integer tensors. Returns the last suffix token's logits [vocab]."""
    s = tokens.shape[1]
    block_k = pool['k'].shape[2]
    device = tokens.device
    suffix_len = _length(suffix_len, device)
    prefix_len = _length(prefix_len, device)
    positions = prefix_len + torch.arange(s, dtype=torch.int32,
                                          device=device)
    cos, sin = llama._rope_freqs(cfg, positions)  # pylint: disable=protected-access
    x = _embed(params, tokens, cfg)
    pk, pv = _gather_prefix_kv(pool, prefix_blocks, cfg.dtype)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        layer = llama.layer_params(params, i)
        q, k, v = llama.qkv(cfg, x, layer, cos, sin)
        attn = _prefix_suffix_attention(q, pk[i][None], pv[i][None], k, v,
                                        prefix_len)
        x = _attend_out(cfg, x, attn, layer)
        ks.append(k[0])
        vs.append(v[0])
    x = llama.rms_norm(x, params['out_norm'], cfg.norm_eps)
    # Token i sits at global position prefix_len + i → block
    # block_row[(off0 + i) // block_k], offset (off0 + i) % block_k.
    g = (prefix_len % block_k) + torch.arange(s, device=device)
    blk = block_row.long()[g // block_k]
    _write_kv(pool, (slice(None), blk, g % block_k), torch.stack(ks),
              torch.stack(vs))
    return _logits(params, _row_at(x[0], suffix_len - 1))


# --------------------------------------------------- speculative decoding


def gather_layer_kv(lpool: Cache, block_tables: torch.Tensor,
                    dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's pool → per-sequence contiguous K/V [B, n*block_k, Hkv,
    hd] through the tables ``[B, n]`` (int8 pools dequantise here): the
    drafter's attention history. Callers pass the tables narrowed to the
    live block count, so only the live prefix is gathered."""
    k, v, ks, vs = decode_attention_ops.gather_paged_kv(
        lpool['k'], lpool['v'], block_tables, lpool.get('k_scale'),
        lpool.get('v_scale'))
    if ks is not None:
        k = k.float() * ks[..., None]
        v = v.float() * vs[..., None]
    return k.to(dtype), v.to(dtype)


def draft_attention(q: torch.Tensor, hist_k: torch.Tensor,
                    hist_v: torch.Tensor, hist_len: torch.Tensor,
                    buf_k: torch.Tensor, buf_v: torch.Tensor,
                    n_filled: int) -> torch.Tensor:
    """Drafter attention: q [B,1,H,hd] against the pool-gathered history
    (positions < hist_len, per row) plus this round's local K/V buffer
    ([B, spec_k, Hkv, hd], entries < ``n_filled`` live, the current draft
    token's own included), in one joint softmax. No pool write happens
    while drafting, so a rejected tail needs no rollback in the drafter
    layers. Plain PyTorch, as the reference computes it outside any
    kernel."""
    t_hist = hist_k.shape[1]
    k = torch.cat([hist_k, buf_k], dim=1)
    v = torch.cat([hist_v, buf_v], dim=1)
    t_idx = torch.arange(k.shape[1], device=q.device)[None, :]
    # [B, T+K]: history gates on hist_len, the buffer on the fill count.
    mask = torch.where(t_idx < t_hist,
                       t_idx < hist_len.to(q.device)[:, None],
                       (t_idx - t_hist) < n_filled)
    return decode_attention_ops.grouped_attention_plain(
        q, k, v, mask[:, None, :], None, None)


def spec_draft_tokens(params: Params, token: torch.Tensor,
                      pos: torch.Tensor, block_tables: torch.Tensor,
                      cfg: llama.LlamaConfig, dcfg: DecodeConfig,
                      pool: Cache) -> torch.Tensor:
    """Greedy-draft ``spec_k`` tokens per sequence with the truncated-
    layer drafter. token [B] (the last emitted token, its K/V not yet
    written) at positions pos [B]. Returns drafts [B, spec_k] int64. The
    pool is read (one history gather per drafter layer) and never
    written: verify owns every cache write, which makes rejection
    rollback purely positional. Counterpart of the reference's
    ``_spec_draft_tokens``."""
    k_spec = dcfg.spec_k
    d = dcfg.spec_drafter_layers
    if not 1 <= d <= cfg.n_layers:
        raise ValueError(f'spec_drafter_layers must be in [1, '
                         f'{cfg.n_layers}], got {d}')
    b = token.shape[0]
    pos = pos.long()
    layers = [llama.layer_params(params, i) for i in range(d)]
    hist = [gather_layer_kv(_layer_cache(pool, i), block_tables, cfg.dtype)
            for i in range(d)]
    # [Hkv, hd] of the pool: a tensor-parallel rank's Hkv/tp heads.
    buf_shape = (b, k_spec) + tuple(pool['k'].shape[3:])
    device = token.device
    buf_k = [torch.zeros(buf_shape, dtype=cfg.dtype, device=device)
             for _ in range(d)]
    buf_v = [torch.zeros(buf_shape, dtype=cfg.dtype, device=device)
             for _ in range(d)]
    drafts = []
    tok = token
    for j in range(k_spec):
        cos, sin = llama._rope_freqs(cfg, (pos + j)[:, None])  # pylint: disable=protected-access
        x = _embed(params, tok, cfg)[:, None]
        for li, layer in enumerate(layers):
            q, kx, vx = llama.qkv(cfg, x, layer, cos, sin)
            buf_k[li][:, j] = kx[:, 0]
            buf_v[li][:, j] = vx[:, 0]
            attn = draft_attention(q, hist[li][0], hist[li][1], pos,
                                   buf_k[li], buf_v[li], j + 1)
            x = _attend_out(cfg, x, attn, layer)
        x = llama.rms_norm(x, params['out_norm'], cfg.norm_eps)
        tok = _logits(params, x[:, 0]).argmax(dim=-1)
        drafts.append(tok)
    return torch.stack(drafts, dim=1)


def _attend_paged_verify(dcfg: DecodeConfig, q: torch.Tensor,
                         lpool: Cache, block_tables: torch.Tensor,
                         start_pos: torch.Tensor) -> torch.Tensor:
    """q [B,S,H,hd] against one layer's pool; query ``i`` masks by its
    own causal length ``start_pos + i + 1``."""
    return decode_attention_ops.paged_verify_attention(
        q, lpool['k'], lpool['v'], block_tables, start_pos,
        lpool.get('k_scale'), lpool.get('v_scale'),
        impl=dcfg.decode_attention)


def paged_verify_step(params: Params, tokens: torch.Tensor,
                      pos: torch.Tensor, block_tables: torch.Tensor,
                      cfg: llama.LlamaConfig, dcfg: DecodeConfig,
                      pool: Cache) -> torch.Tensor:
    """Multi-token full-model step: score tokens [B, S] (the last emitted
    token followed by S-1 drafts) at positions pos..pos+S-1 → logits [B,
    S, vocab]. Counterpart of the reference's ``_paged_verify_step``.

    Per layer the K/V of all S positions are written through the tables
    before attention (the single-token step's write-then-attend order),
    so the accepted prefix's cache entries are already right when the
    host commits it; a rejected tail is rolled back by not advancing
    ``pos`` past it. Positions at or past the table's capacity (a lane
    that drafted past ``max_len``) write to the scratch block 0 instead
    of wrapping into a live block."""
    b, s = tokens.shape
    block_k = pool['k'].shape[2]
    max_len = block_tables.shape[1] * block_k
    pos = pos.long()
    positions = pos[:, None] + torch.arange(s, device=pos.device)  # [B, S]
    cos, sin = llama._rope_freqs(cfg, positions)  # pylint: disable=protected-access
    x = _embed(params, tokens, cfg)
    pidx = positions.clamp(max=max_len - 1)
    blk = block_tables.long().gather(1, pidx // block_k)
    blk = torch.where(positions < max_len, blk, 0)
    tables = block_tables.to(torch.int32)
    start = pos.to(torch.int32)
    for i in range(cfg.n_layers):
        layer = llama.layer_params(params, i)
        lcache = _layer_cache(pool, i)
        q, k, v = llama.qkv(cfg, x, layer, cos, sin)
        _write_kv(lcache, (blk, pidx % block_k), k, v)
        attn = _attend_paged_verify(dcfg, q, lcache, tables, start)
        x = _attend_out(cfg, x, attn, layer)
    x = llama.rms_norm(x, params['out_norm'], cfg.norm_eps)
    return _logits(params, x)


def copy_block(pool: Cache, src: int, dst: int) -> None:
    """Copy one pool block (all layers, scales included) in place — the
    device half of copy-on-write."""
    for t in pool.values():
        t[:, dst] = t[:, src]


def inject_pool_blocks(pool: Cache, block_idx: torch.Tensor,
                       values: Cache) -> None:
    """Write fetched prefix blocks into the pool in place:
    ``values[name]`` ``[L, n, block_k, ...]`` lands at pool blocks
    ``block_idx`` [n], every plane (the int8 scale planes included). The
    values arrive in the pool's own storage dtype and are written as
    they are, never cast: a value cast of bytes decoded under a wrong
    dtype would install plausible garbage K/V, so a dtype mismatch
    raises."""
    for name, t in pool.items():
        v = values[name]
        if v.dtype != t.dtype:
            raise ValueError(f'{name}: {v.dtype} values for a {t.dtype} '
                             'pool')
        t[:, block_idx.to(t.device)] = v.to(t.device)


def export_pool_blocks(pool: Cache, block_idx: torch.Tensor) -> Cache:
    """Pool blocks ``block_idx`` [n] of every plane, ``[L, n, block_k,
    ...]``, copied to the host: the owner side of the prefix fetch."""
    return {name: t[:, block_idx.to(t.device)].to('cpu')
            for name, t in pool.items()}


# --------------------------------------------------------------- sampling


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: float) -> torch.Tensor:
    """[B, vocab] → [B] int64: argmax when greedy, else a draw from
    softmax(logits / T) with ``generator``. The draw is
    ``torch.multinomial(probs, 1)``'s own (argmax of the probabilities
    over Exp(1) noise: the same bits and generator state), without its
    argument checks, which read the device back to the host and so
    cannot run inside a CUDA graph."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    noise = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / noise).argmax(dim=-1)


def _check_budget(s_prompt: int, max_new_tokens: int,
                  dcfg: DecodeConfig) -> None:
    if s_prompt + max_new_tokens > dcfg.max_len:
        raise ValueError(
            f'prompt ({s_prompt}) + max_new_tokens ({max_new_tokens}) '
            f'exceeds max_len {dcfg.max_len}')


def generate(params: Params, prompt: torch.Tensor,
             prompt_lens: torch.Tensor, cfg: llama.LlamaConfig,
             dcfg: DecodeConfig, max_new_tokens: int,
             generator: Optional[torch.Generator] = None,
             rounds: str = 'graph') -> torch.Tensor:
    """prompt [B, S_prompt] right-padded → generated tokens [B,
    max_new_tokens] (post-EOS positions hold eos_id). Counterpart of the
    reference's ``generate``, whose ``_generate_impl`` is one jitted
    program over a donated cache.

    ``rounds`` (one of ``cuda_graphs.ROUNDS``): on a CUDA prompt,
    ``'graph'`` replays the CUDA graphs of the key's
    :class:`GenerateProgram` (kept across calls, see
    :func:`_program_for`; a failed capture or replay raises), and
    ``'eager'`` runs the steps one by one over a fresh cache. The CPU
    always runs eagerly. Both give the same tokens."""
    if rounds not in cuda_graphs.ROUNDS:
        raise ValueError(f'rounds must be one of {cuda_graphs.ROUNDS}, '
                         f'got {rounds!r}')
    b, s_prompt = prompt.shape
    _check_budget(s_prompt, max_new_tokens, dcfg)
    device = prompt.device
    # Host-side telemetry, as the reference's generate: KV-cache
    # capacity/occupancy and dtype gauges and a request counter. Latency
    # histograms belong to callers that own a sync boundary
    # (runtime_metrics.record_decode_phase).
    runtime_metrics.record_kv_cache(b, dcfg.max_len,
                                    s_prompt + max_new_tokens,
                                    dcfg.kv_cache_dtype)
    metrics.counter('skytpu_decode_requests_total',
                    'Decode requests (batched generate calls).').inc()
    if rounds == 'graph' and device.type == 'cuda':
        with _PROGRAMS_LOCK:
            program = _program_for(params, cfg, dcfg, b, s_prompt,
                                   max_new_tokens, device, generator)
            return program.run(prompt, prompt_lens)
    cache = init_kv_cache(cfg, b, dcfg.max_len, dcfg.kv_cache_dtype,
                          device)
    lens = prompt_lens.to(device).long()
    token, done = _first_token(params, prompt, lens, cfg, dcfg, cache,
                               generator)
    toks, _, _, _ = _decode_steps(params, token, lens, done,
                                  max_new_tokens - 1, cfg, dcfg, cache,
                                  generator)
    return torch.stack([token] + toks, dim=1)


def _first_token(params: Params, prompt: torch.Tensor, lens: torch.Tensor,
                 cfg: llama.LlamaConfig, dcfg: DecodeConfig, cache: Cache,
                 generator: Optional[torch.Generator]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill and the first token's sample: (token [B], done [B])."""
    last = prefill(params, prompt, cfg, cache, lens)
    token = sample(last, generator, dcfg.temperature)
    eos = dcfg.eos_id
    done = (token == eos if eos is not None else
            torch.zeros_like(token, dtype=torch.bool))
    return token, done


def _decode_steps(params: Params, token: torch.Tensor, pos: torch.Tensor,
                  done: torch.Tensor, n: int, cfg: llama.LlamaConfig,
                  dcfg: DecodeConfig, cache: Cache,
                  generator: Optional[torch.Generator]):
    """``n`` decode steps from (token, pos, done), each sampling, forcing
    EOS on done rows and folding the new EOS into done: ([n tokens
    [B]], token, pos, done) after the last."""
    eos = dcfg.eos_id
    toks = []
    for _ in range(n):
        logits = decode_step(params, token, pos, cfg, dcfg, cache)
        nxt = sample(logits, generator, dcfg.temperature)
        if eos is not None:
            nxt = torch.where(done, eos, nxt)
            done = done | (nxt == eos)
        token, pos = nxt, pos + 1
        toks.append(nxt)
    return toks, token, pos, done


# Decode steps one replayed graph of a compiled generate holds: a call of
# N new tokens replays the prefill's graph once and the steps' graphs
# ceil((N - 1) / GENERATE_ROUND) times (the last holds the remainder).
GENERATE_ROUND = 16
# Compiled generates kept (each holds its own cache and graphs); past
# this the least recently used is dropped.
GENERATE_PROGRAMS = 4


class GenerateProgram:
    """:func:`generate` compiled for one key: the counterpart of the
    reference's ``_generate_impl`` traced for one set of static
    arguments. It holds a dense cache [L, batch, max_len, ...] of its own,
    reused by every call (the reference's donated cache), static input
    buffers (the prompt, its lengths, and the carry between graphs:
    token, position and done per row), and a
    :class:`~skypilot_tpu_torch.models.cuda_graphs.GraphCache` of three
    graphs at most: the prefill with the first token's sample, and the
    decode steps (EOS forcing and the done fold inside) in rounds of
    :data:`GENERATE_ROUND` and of the remainder. A call is thus a
    bounded number of host launches whatever the layer count: per round
    one replay and two copies (the round's tokens out, the carry back
    in). Each call's prefill rewrites positions [0, S_prompt) of every
    row and each step writes its position before attending up to it, so
    no K/V of an earlier call is ever read. ``capturer`` is
    :class:`~skypilot_tpu_torch.models.cuda_graphs.CudaCapturer` on the
    card (with ``generator`` registered, so a sampled call draws fresh
    noise at every replay); the CPU tests hand in a stand-in."""

    def __init__(self, params: Params, cfg: llama.LlamaConfig,
                 dcfg: DecodeConfig, batch: int, prompt_len: int,
                 max_new_tokens: int, device, capturer,
                 generator: Optional[torch.Generator] = None):
        _check_budget(prompt_len, max_new_tokens, dcfg)
        self.params, self.cfg, self.dcfg = params, cfg, dcfg
        self.max_new_tokens = max_new_tokens
        self._generator = generator
        self.cache = init_kv_cache(cfg, batch, dcfg.max_len,
                                   dcfg.kv_cache_dtype, device)
        self._in = {
            'prompt': torch.zeros((batch, prompt_len), dtype=torch.int64,
                                  device=device),
            'lens': torch.zeros((batch,), dtype=torch.int64, device=device),
            'carry': torch.zeros((3, batch), dtype=torch.int64,
                                 device=device)}
        self.graphs = cuda_graphs.GraphCache(capturer)

    def _prefill_body(self) -> torch.Tensor:
        """Prefill and the first token's sample: the first carry."""
        lens = self._in['lens']
        token, done = _first_token(self.params, self._in['prompt'], lens,
                                   self.cfg, self.dcfg, self.cache,
                                   self._generator)
        return torch.stack([token, lens, done.long()])

    def _steps_body(self, n: int) -> torch.Tensor:
        """``n`` decode steps from the carry: [n rows of tokens, then the
        next carry], [n + 3, batch]."""
        token, pos, done = self._in['carry']
        toks, token, pos, done = _decode_steps(
            self.params, token, pos, done.bool(), n, self.cfg, self.dcfg,
            self.cache, self._generator)
        return torch.cat([torch.stack(toks),
                          torch.stack([token, pos, done.long()])])

    def _replay(self, key: tuple, fn) -> torch.Tensor:
        ptrs = tuple(t.data_ptr() for t in itertools.chain(
            self.cache.values(), self._in.values()))
        return self.graphs.run(key, fn, ptrs)

    def run(self, prompt: torch.Tensor,
            prompt_lens: torch.Tensor) -> torch.Tensor:
        """One call: prompt [batch, prompt_len] right-padded → tokens
        [batch, max_new_tokens]."""
        n_new = self.max_new_tokens
        self._in['prompt'].copy_(prompt)
        self._in['lens'].copy_(prompt_lens)
        carry = self._in['carry']
        out = self._replay(('generate_prefill',), self._prefill_body)
        carry.copy_(out)
        tokens = torch.empty((carry.shape[1], n_new), dtype=torch.int64,
                             device=carry.device)
        tokens[:, 0] = out[0]
        col = 1
        while col < n_new:
            n = min(GENERATE_ROUND, n_new - col)
            out = self._replay(('generate_steps', n),
                               functools.partial(self._steps_body, n))
            tokens[:, col:col + n] = out[:n].T
            carry.copy_(out[n:])
            col += n
        return tokens


_PROGRAMS: 'collections.OrderedDict[tuple, GenerateProgram]' = \
    collections.OrderedDict()
# One compiled generate runs at a time: its buffers are shared by calls.
_PROGRAMS_LOCK = threading.Lock()


def _param_ptrs(tree) -> tuple:
    """The addresses of every tensor of a params tree (int8 weights'
    values and scales included), in a fixed order."""
    if isinstance(tree, dict):
        return tuple(p for k in sorted(tree) for p in _param_ptrs(tree[k]))
    if isinstance(tree, quant.QuantizedTensor):
        return (tree.values.data_ptr(), tree.scale.data_ptr())
    return (tree.data_ptr(),)


def _program_for(params: Params, cfg: llama.LlamaConfig,
                 dcfg: DecodeConfig, batch: int, prompt_len: int,
                 max_new_tokens: int, device,
                 generator: Optional[torch.Generator]) -> GenerateProgram:
    """The compiled generate of this key, made at its first call. The key
    is what the reference's jit keys on: the shapes (batch, prompt
    length, new tokens), both configs (the K/V dtype and the temperature
    among them), the weights' kind (int8 or not) and the params'
    storages; and, for a sampled call, the generator the graphs
    registered. The program holds the params and the generator, so
    neither their addresses nor its id can pass to other objects while
    it is kept."""
    int8 = isinstance(params['layers']['wq'], quant.QuantizedTensor)
    key = (cfg, dcfg, batch, prompt_len, max_new_tokens, str(device), int8,
           _param_ptrs(params),
           id(generator) if dcfg.temperature != 0.0 else None)
    program = _PROGRAMS.get(key)
    if program is None:
        if dcfg.temperature == 0.0:
            generator = None
        program = GenerateProgram(
            params, cfg, dcfg, batch, prompt_len, max_new_tokens, device,
            cuda_graphs.CudaCapturer(device, generator), generator)
        _PROGRAMS[key] = program
        while len(_PROGRAMS) > GENERATE_PROGRAMS:
            _PROGRAMS.popitem(last=False)
    _PROGRAMS.move_to_end(key)
    return program


def generate_programs() -> list:
    """The compiled generates kept, least recently used first."""
    return list(_PROGRAMS.values())


def clear_generate_programs() -> None:
    """Drop every compiled generate, with its cache and graphs."""
    with _PROGRAMS_LOCK:
        _PROGRAMS.clear()


def completed_token_counts(tokens, eos_id: Optional[int]) -> np.ndarray:
    """Per-sequence GENERATED token counts of a [B, T] generation: the
    EOS token counts, the post-EOS padding does not."""
    t = np.asarray(tokens)
    b, n = t.shape
    if eos_id is None:
        return np.full((b,), n, dtype=np.int64)
    is_eos = t == eos_id
    return np.where(is_eos.any(axis=1), is_eos.argmax(axis=1) + 1,
                    n).astype(np.int64)
