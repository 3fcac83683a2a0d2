"""Decoder models of the port (``repro/models/transformer.py``): all six
families of the reference.

    hybrid (RecurrentGemma), unrolled over the block pattern
    ("rec", "rec", "attn"):
      rec  : [RMSNorm → RG-LRU block → +] [RMSNorm → SwiGLU → +]
      attn : [RMSNorm → local attention → +] [RMSNorm → SwiGLU → +]
    dense (Qwen3, MiniCPM, Mistral-NeMo, DeepSeek, the paper's char-LM):
      [RMSNorm → GQA attention (qk-norm where set) → +] [RMSNorm → SwiGLU → +] × L
    moe (Grok-1, Arctic):
      [RMSNorm → GQA attention → +] [RMSNorm → MoE FFN (+ dense residual) → +] × L
    ssm (RWKV6):
      [RMSNorm → time-mix → +] [RMSNorm → channel-mix → +] × L
    audio / vlm (MusicGen, LLaVA-NeXT): the dense wiring over a prefix of
      stub-frontend embeddings (``models.multimodal``) prepended to the
      token embeddings (``prefix_embeds``, ``batch["prefix"]``): positions
      run over both, and logits and the loss cover text positions only

The homogeneous stacks (every family but hybrid) keep the reference's
layer-stacked layout: each of their leaves has a leading layer axis
(``layers.attn.wq`` is (L, d, H·dh), ``layers.ffn.w_gate`` of an MoE (L,
E, d, f), ``layers.time_mix.w_r`` (L, d, d)), as the reference's
``init_model`` builds it under ``jax.vmap``, so the weights carry across
one to one and a decentralized trainer gossips the same leaves the
reference gossips.  Their layer runner reads layer ``i`` of every leaf
through a view, from the module or from a flat ``dict[str, Tensor]``
(``{"layers.attn.wq": ..., ...}``, the dict a trainer stacks per worker).

Entry points share one layer runner:
  * ``forward``     — full-sequence logits (B, T, V), with the MoE aux loss
    on request (``with_aux``)
  * ``lm_loss``     — next-token cross-entropy of every family (moe: plus
    ``aux_weight`` times the MoE load-balance loss), optionally with the
    unembedding and the softmax in sequence chunks (``logit_chunk``) and
    each layer and CE chunk rematerialised (``remat``); differentiable,
    as the reference's training forward, which never reaches a Pallas
    kernel: its attention is ``_plain_attention`` or, past T = 1024,
    ``blockwise_attention``, and its RG-LRU recurrence the chunked
    ``rglru_train_scan``
  * ``prefill``     — full sequence; last-token logits (B, V) + decode state
  * ``decode_step`` — one token against the decode state

Decode state is a tuple with one entry per layer: ``RGLRUState`` for a
recurrent layer, ``RWKVState`` for an RWKV layer (its size independent of
the sequence's length), a rolling ``KVCache`` for an attention layer.  The
weights do not require gradients: training differentiates ``lm_loss``
with respect to a flat parameter dict (``torch.autograd.grad`` in
``launch/steps.py``; ``torch.func.grad`` in the decentralized trainer,
which cannot carry the rematerialisation (``layers.rematerialise``), so
there ``remat`` stays off, which leaves every step of the forward
transformable at any length).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv as RW
from repro_torch.models.layers import KVCache


FAMILIES = ("hybrid", "dense", "moe", "ssm", "audio", "vlm")
STACKED = ("dense", "moe", "ssm", "audio", "vlm")   # homogeneous, layer-stacked


def _require_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}): this runs "
            f"{', '.join(FAMILIES)}")


def block_pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.family == "ssm":
        return ("rwkv",) * cfg.n_layers
    return cfg._pattern_expanded()


class AttnLayer(nn.Module):
    def __init__(self, cfg, gen, device):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.attn = L.Attention(cfg, gen, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.ffn = L.MLP(cfg.d_model, cfg.d_ff, cfg.pdtype, device, gen)


class RecLayer(nn.Module):
    def __init__(self, cfg, gen, device):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.rec = RG.RGLRUBlock(cfg, gen, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.ffn = L.MLP(cfg.d_model, cfg.d_ff, cfg.pdtype, device, gen)


class LayerStack(nn.Module):
    """The L identical blocks of a dense or moe model, layer-stacked: every
    leaf has a leading layer axis (``ln1.scale`` (L, d), ``attn.wq`` (L, d,
    H·dh)); the FFN is a SwiGLU MLP or an MoE (``ffn.router`` (L, d, E))."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        lead = (cfg.n_layers,)
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.pdtype, device, lead)
        self.attn = L.Attention(cfg, gen, device, lead)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.pdtype, device, lead)
        if cfg.family == "moe":
            self.ffn = MOE.MoE(cfg, gen, device, lead)
        else:
            self.ffn = L.MLP(cfg.d_model, cfg.d_ff, cfg.pdtype, device, gen, lead)


class RWKVLayer(nn.Module):
    """The L blocks of an ssm model, layer-stacked (``time_mix.w_r`` (L,
    d, d), ``channel_mix.w_k`` (L, d, f))."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        lead = (cfg.n_layers,)
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.pdtype, device, lead)
        self.time_mix = RW.TimeMix(cfg, gen, device, lead)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.pdtype, device, lead)
        self.channel_mix = RW.ChannelMix(cfg, gen, device, lead)


class Head(nn.Module):
    def __init__(self, cfg, gen, device):
        super().__init__()
        self.w = L.weight((cfg.d_model, cfg.vocab_size), cfg.pdtype, device,
                          gen, scale=0.02)


class LM(nn.Module):
    """The model's weights; ``state_dict`` keys are the reference's pytree
    paths (``embed.table``, ``layers.0.rec.w_in`` or, stacked,
    ``layers.attn.wq``, ``layers.ffn.router``, ``layers.time_mix.w_r``,
    ``head.w``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        _require_family(cfg)
        self.embed = L.Embedding(cfg.vocab_size, cfg.d_model, cfg.pdtype,
                                 device, gen)
        if cfg.family == "ssm":
            self.layers = RWKVLayer(cfg, gen, device)
        elif cfg.family in STACKED:
            self.layers = LayerStack(cfg, gen, device)
        else:
            kinds = {"attn": AttnLayer, "rec": RecLayer}
            self.layers = nn.ModuleList(kinds[pt](cfg, gen, device)
                                        for pt in block_pattern(cfg))
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        if not cfg.tie_embeddings:
            self.head = Head(cfg, gen, device)


def init_model(cfg: ModelConfig, gen: Optional[torch.Generator],
               device: DeviceLike = "cuda") -> LM:
    """The model on ``device``, its weights drawn from ``gen`` with the
    reference's initialisers (uninitialised when ``gen`` is None, for a
    load).  The draws happen on ``gen``'s device.  ``device="meta"`` with
    ``gen`` None builds the shapes alone, allocating nothing."""
    dev = resolve_device(device, shapes_only=gen is None)
    return LM(cfg, dev, gen)


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count from the model's shapes (built on the meta
    device: nothing is allocated)."""
    return sum(p.numel() for p in LM(cfg, torch.device("meta")).parameters())


def active_param_count(cfg: ModelConfig) -> int:
    """Per-token active parameters (an MoE counts its top-k experts only)."""
    total = param_count(cfg)
    if cfg.family != "moe":
        return total
    per_expert = 3 * cfg.d_model * cfg.d_ff
    return total - cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert


def flat_params(model: LM) -> Dict[str, torch.Tensor]:
    """The model's weights as a flat dict keyed by pytree path (the same
    tensors, not copies)."""
    return dict(model.named_parameters())


Params = Union[LM, Dict[str, torch.Tensor]]


class _View:
    """Attribute access to a flat parameter dict: ``v.attn.wq`` is the leaf
    ``{prefix}attn.wq``.  The layer functions read weights through it as
    they read a module's."""

    __slots__ = ("_flat", "_prefix")

    def __init__(self, flat: Dict[str, torch.Tensor], prefix: str = ""):
        self._flat, self._prefix = flat, prefix

    def __getattr__(self, name: str):
        key = self._prefix + name
        leaf = self._flat.get(key)
        if leaf is not None:
            return leaf
        if not any(k.startswith(key + ".") for k in self._flat):
            raise AttributeError(f"no parameter {key!r}")
        return _View(self._flat, key + ".")


def _stacked_layers(flat: Dict[str, torch.Tensor], n_layers: int):
    """One view per layer of the layer-stacked leaves.  Each leaf is split
    once (``unbind``), so a gradient reaches it through one stack of its
    layers' gradients, not one full-size add per layer as indexing would
    give."""
    per_leaf = {k[len("layers."):]: v.unbind(0) for k, v in flat.items()
                if k.startswith("layers.")}
    return [_View({k: t[i] for k, t in per_leaf.items()})
            for i in range(n_layers)]


def _weights(model: Params, cfg: ModelConfig):
    """What the layer runner reads: the hybrid model's modules, or a view of
    the flat parameters (a stacked model's, from the module or a dict; a
    hybrid model's dict)."""
    _require_family(cfg)
    if cfg.family in STACKED:
        flat = model if isinstance(model, dict) else flat_params(model)
        return _View(flat)
    return _View(model) if isinstance(model, dict) else model


# ---------------------------------------------------------------------------
# Layer runner
# ---------------------------------------------------------------------------

def _apply_attn_layer(p: AttnLayer, cfg, x, positions, state, window,
                      build_cache=None, train=False, remat=False):
    h = L.rmsnorm(p.ln1, x, cfg.norm_eps)
    attn_out, new_state = L.apply_attention(
        p.attn, cfg, h, positions, cache=state, window=window,
        build_cache=build_cache, plain=train, remat=remat)
    x = x + attn_out
    h = L.rmsnorm(p.ln2, x, cfg.norm_eps)
    if cfg.family == "moe":
        ffn_out, aux = MOE.apply_moe(p.ffn, cfg, h)
        return x + ffn_out, new_state, aux
    return x + L.apply_mlp(p.ffn, h), new_state, None


def _apply_rwkv_layer(p: RWKVLayer, cfg, x, state: Optional[RW.RWKVState]):
    h = L.rmsnorm(p.ln1, x, cfg.norm_eps)
    tm_out, S_new, last_tm = RW.apply_time_mix(p.time_mix, cfg, h, state)
    x = x + tm_out
    h = L.rmsnorm(p.ln2, x, cfg.norm_eps)
    cm_out, last_cm = RW.apply_channel_mix(
        p.channel_mix, h, state.shift_cm if state is not None else None)
    return x + cm_out, RW.RWKVState(shift_tm=last_tm, shift_cm=last_cm, S=S_new)


def _apply_rec_layer(p: RecLayer, cfg, x, state, train_scan=False,
                     remat=False):
    h = L.rmsnorm(p.ln1, x, cfg.norm_eps)
    rec_out, new_state = RG.apply_rglru_block(p.rec, cfg, h, state, train_scan,
                                              remat)
    x = x + rec_out
    h = L.rmsnorm(p.ln2, x, cfg.norm_eps)
    return x + L.apply_mlp(p.ffn, h), new_state


def _run_layers(m, cfg: ModelConfig, x, positions, *, states=None,
                build_cache: Optional[int] = None, train: bool = False,
                remat: bool = False):
    """Run all blocks of ``m`` (from ``_weights``).  Returns (x, aux,
    new_states_or_None); aux is the sum of the MoE layers' load-balance
    losses (float32 0 for the other families).

    states given       → decode (per-layer state in/out)
    build_cache = size → prefill: construct decode states
    neither            → plain forward
    ``train`` is the differentiable training forward of ``lm_loss``: the
    reference's attention (``_plain_attention``, past T = 1024
    ``blockwise_attention`` or, for bf16 CUDA inputs at dh 64 / 128, the
    training kernels of ``swa_attention_train``) instead of the prefill
    ``swa_attention`` kernel, and the
    chunked ``rglru_train_scan`` instead of the ``linear_scan`` kernel.
    ``remat`` runs each layer under ``layers.rematerialise`` (the
    reference's ``jax.checkpoint`` per layer), and within it each of
    blockwise attention's q blocks and each chunk of the scan: the backward
    keeps the layers' inputs and recomputes the rest.
    """
    window = cfg.attn_window
    collect = (states is not None) or (build_cache is not None)
    pattern = block_pattern(cfg)
    if cfg.family in STACKED:
        layer_weights = _stacked_layers(m._flat, cfg.n_layers)
    elif isinstance(m, _View):
        layer_weights = [_View(m._flat, f"layers.{i}.")
                         for i in range(cfg.n_layers)]
    else:
        layer_weights = m.layers
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_states = []
    for i, (pt, lp) in enumerate(zip(pattern, layer_weights)):
        st = states[i] if states is not None else None
        if pt == "attn":
            bc = build_cache if states is None else None
            if bc is not None and window:
                bc = min(bc, window)
            fn = (lambda x, lp=lp, st=st, bc=bc: _apply_attn_layer(
                lp, cfg, x, positions, st, window, bc, train, remat))
        elif pt == "rwkv":
            fn = (lambda x, lp=lp, st=st:
                  _apply_rwkv_layer(lp, cfg, x, st) + (None,))
        else:
            fn = (lambda x, lp=lp, st=st:
                  _apply_rec_layer(lp, cfg, x, st, train, remat) + (None,))
        x, st2, a = L.rematerialise(fn, x) if remat else fn(x)
        if a is not None:
            aux = aux + a
        new_states.append(st2)
    return x, aux, (tuple(new_states) if collect else None)


def _logits(m, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Float32 logits."""
    if cfg.tie_embeddings:
        return L.unembed(m.embed, x)
    return L.matmul_f32(x, m.head.w)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _inputs(m, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor]):
    """The embedded tokens after the prefix (cast to the compute dtype), the
    positions 0..P+T-1 over both, and the prefix's length P."""
    x = L.embed(m.embed, tokens).to(cfg.cdtype)
    n_prefix = 0
    if prefix_embeds is not None:
        n_prefix = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(cfg.cdtype), x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return x, positions, n_prefix


def forward(model: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            with_aux: bool = False):
    """tokens: (B, T) int; prefix_embeds: (B, P, D) or None.  Returns
    logits (B, T, V) in float32 -- text positions only, the prefix is
    conditioning -- or, with ``with_aux``, (logits, aux) as the reference
    returns them: aux is the MoE layers' summed load-balance loss (float32
    0 for the other families)."""
    m = _weights(model, cfg)
    x, positions, n_prefix = _inputs(m, cfg, tokens, prefix_embeds)
    x, aux, _ = _run_layers(m, cfg, x, positions)
    x = L.rmsnorm(m.final_norm, x, cfg.norm_eps)
    logits = _logits(m, cfg, x[:, n_prefix:])
    return (logits, aux) if with_aux else logits


def lm_loss(params: Params, cfg: ModelConfig, batch,
            logit_chunk: Optional[int] = None,
            aux_weight: float = 0.01, remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy (float32 scalar) of any family, plus
    ``aux_weight`` times the MoE load-balance loss, as the reference.

    ``params`` is the ``LM`` or one worker's flat parameter dict; batch:
    {"tokens": (B, T) int, ["prefix": (B, P, D)]}.  Hidden state t predicts
    token t + 1 over the text positions (the prefix is stripped first).  The
    forward is the differentiable training one (``_run_layers(train=True)``).
    With ``logit_chunk`` the unembedding and the softmax run over sequence
    chunks of that many positions, summed in the reference's order (full
    chunks, then the remainder).  ``remat`` rematerialises each layer (and
    in it blockwise attention's q blocks and the scan's chunks) and each CE
    chunk in the backward pass (``layers.rematerialise``), as the
    reference's ``remat=True`` and its checkpointed CE chunks: the backward
    keeps the layers' inputs, not their intermediates, nor any chunk's
    logits.  Without ``remat`` nothing is checkpointed, so ``torch.func``
    can differentiate it at any length.
    """
    m = _weights(params, cfg)
    tokens = batch["tokens"]
    x, positions, n_prefix = _inputs(m, cfg, tokens, batch.get("prefix"))
    x, aux, _ = _run_layers(m, cfg, x, positions, train=True, remat=remat)
    x = L.rmsnorm(m.final_norm, x, cfg.norm_eps)
    x = x[:, n_prefix:-1]            # shift: predict token t+1 from hidden t
    targets = tokens[:, 1:].long()

    def ce(xc, tc):
        logp = torch.log_softmax(_logits(m, cfg, xc), dim=-1)
        return -torch.take_along_dim(logp, tc[..., None], dim=-1)[..., 0].sum()

    if logit_chunk and x.shape[1] > logit_chunk:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for a in range(0, x.shape[1], logit_chunk):
            xc, tc = x[:, a:a + logit_chunk], targets[:, a:a + logit_chunk]
            total = total + (L.rematerialise(ce, xc, tc) if remat
                             else ce(xc, tc))
    else:
        total = ce(x, targets)
    return total / (targets.shape[0] * targets.shape[1]) + aux_weight * aux


def prefill(model: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int, prefix_embeds: Optional[torch.Tensor] = None):
    """Full-sequence prefill of the prefix (B, P, D), if any, then the
    tokens.  Returns (last-token logits (B, V), decode state); only the
    last position reaches the head.  The next token's position is P + T,
    and ``cache_len`` must hold P + T + the tokens still to decode."""
    m = _weights(model, cfg)
    x, positions, _ = _inputs(m, cfg, tokens, prefix_embeds)
    x, _, states = _run_layers(m, cfg, x, positions, build_cache=cache_len)
    x = L.rmsnorm(m.final_norm, x[:, -1:], cfg.norm_eps)
    return _logits(m, cfg, x)[:, 0], states


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device: DeviceLike = "cuda", filled: bool = False):
    """Empty per-layer decode state sized for a KV history of ``cache_len``;
    the attention cache is ``min(window, cache_len)`` slots (rolling).  An
    ssm layer's state is zeros of a fixed size (S float32 (B, H, K, K)).
    ``filled`` marks the slots as holding positions [cache_len − size,
    cache_len), as the reference's flag does (a decode step's mask reads
    them: an empty slot, -1, is masked).  ``device="meta"`` builds the
    shapes alone (the dry run's abstract inputs)."""
    _require_family(cfg)
    dev = resolve_device(device, shapes_only=True)
    window = cfg.attn_window
    attn_len = min(window, cache_len) if window else cache_len
    dt = cfg.cdtype
    if cfg.family == "ssm":
        return tuple(RW.RWKVState.zeros(batch, cfg, dt, dev)
                     for _ in range(cfg.n_layers))

    def attn_state():
        c = KVCache.empty(batch, attn_len, cfg.n_kv_heads, cfg.d_head, dt, dev)
        if filled:
            pos = torch.arange(cache_len - attn_len, cache_len,
                               dtype=torch.int32, device=dev)
            c.positions[(pos % attn_len).long()] = pos
        return c

    return tuple(attn_state() if pt == "attn"
                 else RG.RGLRUState.zeros(batch, cfg, dt, dev)
                 for pt in block_pattern(cfg))


def decode_step(model: Params, cfg: ModelConfig, token: torch.Tensor, state,
                pos: int):
    """One decode step.  token: (B,); pos: the token's absolute position.

    Returns (logits (B, V) float32, new_state); the attention layers'
    caches are updated in place.
    """
    m = _weights(model, cfg)
    x = L.embed(m.embed, token[:, None]).to(cfg.cdtype)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    x, _, new_state = _run_layers(m, cfg, x, positions, states=state)
    x = L.rmsnorm(m.final_norm, x, cfg.norm_eps)
    return _logits(m, cfg, x)[:, 0], new_state
