"""A configuration's sizes, and its weights made on the device from the
seed.

The weights are the benchmark's input, handed alike to the program and
to the plain reference. Each leaf is one ``normal_(0, std)`` call with
the configuration's ``initializer_range`` as std (norm weights are
ones), in the dtype it is served or trained in, from a generator of its
own seeded by ``(seed, leaf index)``: a few large calls on the card, and any one leaf can be drawn again alone, which the
training check uses to find the update of each leaf. The layout is the
one the port applies (``x @ W`` on ``[in, out]`` weights, each layer
weight stacked ``[L, ...]``; experts ``[L, E, d, f]`` and
``[L, E, f, d]``; the router ``[L, d, E]`` in fp32).
"""
import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes a run needs, read from a configuration file."""
    vocab: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn_dim: int
    rope_theta: float
    norm_eps: float
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0
    router_aux_coef: float = 0.0
    init_std: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def moe(self) -> bool:
        return self.n_experts > 0


def load_config(path) -> dict:
    return json.loads(Path(path).read_text())


def dims_of(config: dict) -> Dims:
    """The sizes of a configuration file written with the published
    config's keys (a mixture of experts has ``num_local_experts``)."""
    moe = 'num_local_experts' in config
    assumed = config.get('assumed', {})
    return Dims(
        vocab=config['vocab_size'], dim=config['hidden_size'],
        n_layers=config['num_hidden_layers'],
        n_heads=config['num_attention_heads'],
        n_kv_heads=config['num_key_value_heads'],
        ffn_dim=config['intermediate_size'],
        rope_theta=float(config['rope_theta']),
        norm_eps=float(config['rms_norm_eps']),
        n_experts=config.get('num_local_experts', 0),
        top_k=config.get('num_experts_per_tok', 0),
        capacity_factor=(float(assumed['capacity_factor']['value'])
                         if moe else 0.0),
        router_aux_coef=float(config.get('router_aux_loss_coef', 0.0)),
        init_std=float(config['initializer_range']))


def leaf_specs(d: Dims) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(path, shape, dtype name) of every leaf in drawing order; the
    path of a layer weight is ``layers/<name>``."""
    L, hd = d.n_layers, d.head_dim
    specs = [('tok_embedding', (d.vocab, d.dim), 'bfloat16'),
             ('out_norm', (d.dim,), 'bfloat16'),
             ('lm_head', (d.dim, d.vocab), 'bfloat16'),
             ('layers/attn_norm', (L, d.dim), 'bfloat16'),
             ('layers/wq', (L, d.dim, d.n_heads * hd), 'bfloat16'),
             ('layers/wk', (L, d.dim, d.n_kv_heads * hd), 'bfloat16'),
             ('layers/wv', (L, d.dim, d.n_kv_heads * hd), 'bfloat16'),
             ('layers/wo', (L, d.n_heads * hd, d.dim), 'bfloat16'),
             ('layers/ffn_norm', (L, d.dim), 'bfloat16')]
    if d.moe:
        e, f = d.n_experts, d.ffn_dim
        specs += [('layers/router', (L, d.dim, e), 'float32'),
                  ('layers/we1', (L, e, d.dim, f), 'bfloat16'),
                  ('layers/we3', (L, e, d.dim, f), 'bfloat16'),
                  ('layers/we2', (L, e, f, d.dim), 'bfloat16')]
    else:
        specs += [('layers/w1', (L, d.dim, d.ffn_dim), 'bfloat16'),
                  ('layers/w3', (L, d.dim, d.ffn_dim), 'bfloat16'),
                  ('layers/w2', (L, d.ffn_dim, d.dim), 'bfloat16')]
    return specs


def leaf_seed(seed: int, index: int) -> int:
    """A 64-bit generator seed for leaf ``index`` of run ``seed`` (any
    whole number)."""
    ss = np.random.SeedSequence([int(seed) % 2**64, index])
    return int(ss.generate_state(1, dtype=np.uint64)[0])


def draw_leaf(path: str, shape, dtype_name: str, std: float, seed: int,
              index: int, device,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One leaf, in one call; into ``out`` when given."""
    dtype = getattr(torch, dtype_name)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    if path.endswith('norm'):
        return out.fill_(1.0)
    gen = torch.Generator(device=out.device)
    gen.manual_seed(leaf_seed(seed, index))
    return out.normal_(0.0, std, generator=gen)


def make_params(d: Dims, seed: int, device) -> Dict:
    """The whole param tree of ``d`` from ``seed`` on ``device``."""
    params: Dict = {'layers': {}}
    for i, (path, shape, dt) in enumerate(leaf_specs(d)):
        leaf = draw_leaf(path, shape, dt, d.init_std, seed, i, device)
        set_leaf(params, path, leaf)
    return params


def refill_params(params: Dict, d: Dims, seed: int) -> None:
    """Draw ``seed``'s weights into the tensors of ``params`` in place
    (a program that captured them keeps reading the same storage)."""
    for i, (path, shape, dt) in enumerate(leaf_specs(d)):
        draw_leaf(path, shape, dt, d.init_std, seed, i, None,
                  out=get_leaf(params, path))


def get_leaf(params: Dict, path: str) -> torch.Tensor:
    node = params
    for part in path.split('/'):
        node = node[part]
    return node


def set_leaf(params: Dict, path: str, value) -> None:
    parts = path.split('/')
    node = params
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value
