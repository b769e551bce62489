"""Qwen2-MoE decoder: training, cached decode and serving.

Port of ``paddle_tpu/models/qwen2_moe.py``: ``Qwen2MoeConfig`` (the
defaults are Qwen1.5-MoE-A2.7B's published widths; ``tiny`` for tests),
``init_params`` (seeded ``torch.Generator``; the router in f32),
``decoder_layer`` (Llama attention, then a routed MoE FFN plus a gated
shared expert), ``forward``, ``loss_fn``, ``make_train_step`` and
``make_batch`` (``params_from_jax``, ``init_kv_cache`` and
``init_serving_pages`` are the Llama ones).

Mesh training (``make_train_step(cfg, mesh=init_hybrid_mesh(dp=, ep=,
tp=))``, one process a rank over ``torch.distributed``): ``param_specs``
/ ``shard_params`` / ``gather_params`` as the JAX layouts (the routed
experts ep-sharded on E and tp-sharded on F); each block runs Llama's
sequence-parallel attention half (``llama._sp_attention``, the plain
norm and rope) and ``_moe_half``: the routed experts through
``incubate.moe.functional.moe_ffn_sharded`` (the gating global over the
dp batch, this rank's experts on its rows' slots, the partial combine
all-reduced over ep) and the shared expert column-/row-parallel, one
reduce-scatter over tp for both. The head and the loss are Llama's
vocab-parallel ones. As in the JAX package, ``moe_impl="dropless"``
runs the einsum path on any mesh with dp, ep or tp above 1 (the
grouped-matmul kernels run only unsharded), and a mesh has no pp or cp
axis above 1 and no ZeRO stage.

Decode and serving: ``init_kv_cache`` / ``forward_with_cache`` /
``generate`` (dense KV cache; the prompt's attention on the flash
kernels as ``use_flash_attention`` says) and the serving functions
``init_serving_pages``, ``serving_prefill``, ``serving_prefill_chunk``,
``serving_decode_step``, ``serving_decode_block``, ``serving_tick`` and
``serving_tick_block``: the Llama functions (``models/llama.py``) with
this model's block, ``_decode_block``, so the same ragged and paged
attention kernels run under it and ``ServingEngine`` serves it
(``model="qwen2_moe"`` or inferred from the config). ``_decode_block``
routes DROP-FREE: the einsum ``moe_ffn`` at capacity factor
``num_experts / num_experts_per_tok`` makes each expert's capacity the
cohort size, so no token is dropped and a token's FFN does not depend
on what shares its tick. Its projections go through ``llama._mm``, so
weight-only int8 params (``quantization.quantize_for_decode``) run q, k,
v, o, the shared expert and ``lm_head`` on the int8 matmul kernel; the
routed experts are dequantized to ``cfg.dtype`` for the einsum on every
call, as the JAX block's ``_dense_w`` does (XLA fuses that cast into
the einsum; eager PyTorch makes a dense copy of the layer's experts).

The params are a plain dict in the JAX layouts: weights ``[in, out]``,
per-layer tensors stacked on a leading ``L`` axis, the routed experts
under ``layers["experts"]`` (``w_gate`` / ``w_up [L, E, D, F]``,
``w_down [L, E, F, D]``) and the shared expert under ``layers["shared"]``.
The trainer (``llama.one_device_trainer``) splits them into per-layer
leaves, nested dicts included, and updates them in place with ``AdamW``.

Attention runs through the flash-attention kernels (``use_flash_attention``,
as ``LlamaConfig``'s switch); rmsnorm and rope are the plain ones, as in
the JAX block. ``moe_impl="dropless"`` runs the MoE FFN on the
grouped-matmul kernels (``use_grouped_matmul`` is their switch: True /
"auto", "kernel", False / "reference"); ``"einsum"`` runs the capacity
dispatch in plain PyTorch. On one device dropless always engages (the
JAX package falls back to einsum only on sharded layouts).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..incubate.moe.functional import (moe_ffn, moe_ffn_dropless,
                                       moe_ffn_sharded)
from ..ops.fused.int8_matmul import Int8Weight
from ..ops.kernels.flash_attention import flash_attention
from . import llama
from .llama import _kernel_impl, _layer, _mm, rms_norm, rope

__all__ = ["Qwen2MoeConfig", "init_params", "params_from_jax",
           "decoder_layer", "forward", "loss_fn", "make_train_step",
           "make_batch", "param_specs", "shard_params", "gather_params",
           "init_kv_cache", "forward_with_cache", "generate",
           "init_serving_pages", "serving_prefill", "serving_prefill_chunk",
           "serving_decode_step", "serving_decode_block", "serving_tick",
           "serving_tick_block", "SERVING_KERNELS"]

params_from_jax = llama.params_from_jax
# the serving ticks' kernel libraries: the routed experts run as plain
# einsums in the decode block, so only the ragged attention kernel
SERVING_KERNELS = ("ragged_paged_attention",)
# the dense K/V cache and the serving page pools: the Llama layouts
init_kv_cache = llama.init_kv_cache
init_serving_pages = llama.init_serving_pages


@dataclasses.dataclass
class Qwen2MoeConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    # MoE
    num_experts: int = 60
    num_experts_per_tok: int = 4
    moe_intermediate_size: int = 1408
    shared_expert_intermediate_size: int = 5632
    capacity_factor: float = 2.0
    router_aux_loss_coef: float = 0.001
    # "einsum": capacity dispatch (drops overflow tokens); "dropless": the
    # grouped-matmul kernels, nothing dropped
    moe_impl: str = "einsum"
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # kernel switches: True / "auto" — the Hopper kernel for CUDA tensors,
    # its plain version for CPU tensors; "kernel" — strict; False /
    # "reference" — the plain version
    use_flash_attention: Any = True
    use_grouped_matmul: Any = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def tiny(**kw) -> "Qwen2MoeConfig":
        return Qwen2MoeConfig(
            vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, num_experts=4,
            num_experts_per_tok=2, moe_intermediate_size=32,
            shared_expert_intermediate_size=64, **kw)


def init_params(cfg: Qwen2MoeConfig, generator: torch.Generator,
                device=None, mesh=None) -> Dict:
    """Random params, normal · 1/sqrt(fan_in) (norms at one; the router
    f32 normal · 0.02), drawn from ``generator`` (which must live on
    ``device``) one matrix at a time. With ``mesh`` each leaf is cut to
    this rank's shard (``param_specs``) right after its draw, so no rank
    holds the whole model; the draws, and so the values, are the whole
    init's."""
    dev = resolve_device(device)
    specs = param_specs(cfg)
    cut = (lambda x, sp: x) if mesh is None else (
        lambda x, sp: llama._shard(x, sp, mesh).clone())
    D, V = cfg.hidden_size, cfg.vocab_size
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    L, E = cfg.num_hidden_layers, cfg.num_experts
    Fm, Fs = cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size

    ls, es, ss = specs["layers"], specs["layers"]["experts"], \
        specs["layers"]["shared"]

    def init(shape, fan_in, spec):
        return cut(llama.normal_init(shape, fan_in, cfg.dtype, generator,
                                     dev), spec)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    layers = {
        "wq": init((L, D, H * Dh), D, ls["wq"]),
        "wk": init((L, D, Hkv * Dh), D, ls["wk"]),
        "wv": init((L, D, Hkv * Dh), D, ls["wv"]),
        "wo": init((L, H * Dh, D), H * Dh, ls["wo"]),
        "attn_norm": ones((L, D)),
        "mlp_norm": ones((L, D)),
        "router": torch.randn((L, D, E), generator=generator, device=dev,
                              dtype=torch.float32) * 0.02,
        "experts": {
            "w_gate": init((L, E, D, Fm), D, es["w_gate"]),
            "w_up": init((L, E, D, Fm), D, es["w_up"]),
            "w_down": init((L, E, Fm, D), Fm, es["w_down"]),
        },
        "shared": {
            "w_gate": init((L, D, Fs), D, ss["w_gate"]),
            "w_up": init((L, D, Fs), D, ss["w_up"]),
            "w_down": init((L, Fs, D), Fs, ss["w_down"]),
            # shared-expert gate projection
            "gate": init((L, D, 1), D, ss["gate"]),
        },
    }
    return {"embed": init((V, D), D, specs["embed"]), "layers": layers,
            "final_norm": ones((D,)),
            "lm_head": init((D, V), D, specs["lm_head"])}


def param_specs(cfg: Qwen2MoeConfig) -> Dict[str, Any]:
    """The params' partition specs, as the JAX ``param_specs``: attention
    and the shared expert tp-sharded like Llama's (column-parallel q, k,
    v, ``w_gate``, ``w_up``; row-parallel ``wo``, ``w_down``), the routed
    experts ep-sharded on E and tp-sharded on F, the router and the
    shared expert's gate replicated, the embedding ``P("tp", None)`` and
    ``lm_head`` ``P(None, "tp")``. A stacked layer leaf's leading axis is
    the layer's. An axis absent from the mesh shards nothing."""
    from ..parallel.mesh import P
    layers = {
        "wq": P(None, None, "tp"),
        "wk": P(None, None, "tp"),
        "wv": P(None, None, "tp"),
        "wo": P(None, "tp", None),
        "attn_norm": P(None, None),
        "mlp_norm": P(None, None),
        "router": P(None, None, None),
        "experts": {
            "w_gate": P(None, "ep", None, "tp"),
            "w_up": P(None, "ep", None, "tp"),
            "w_down": P(None, "ep", "tp", None),
        },
        "shared": {
            "w_gate": P(None, None, "tp"),
            "w_up": P(None, None, "tp"),
            "w_down": P(None, "tp", None),
            "gate": P(None, None, None),
        },
    }
    return {"embed": P("tp", None), "layers": layers,
            "final_norm": P(None), "lm_head": P(None, "tp")}


def decoder_layer(lp, h, cfg: Qwen2MoeConfig, positions,
                  use_dropless: bool = False):
    """One block on ``[B, T, D]`` -> (h, the MoE aux loss)."""
    B, T, _ = h.shape
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    x = rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps)
    q = (x @ lp["wq"]).reshape(B, T, H, Dh)
    k = (x @ lp["wk"]).reshape(B, T, Hkv, Dh)
    v = (x @ lp["wv"]).reshape(B, T, Hkv, Dh)
    q, k = rope(q, k, positions, cfg.rope_theta, Dh)
    o = flash_attention(q, k, v, causal=True,
                        impl=_kernel_impl(cfg.use_flash_attention))
    h = h + o.reshape(B, T, H * Dh) @ lp["wo"]

    x = rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
    ex = lp["experts"]
    if use_dropless:
        routed, aux = moe_ffn_dropless(
            x, lp["router"], ex["w_gate"], ex["w_up"], ex["w_down"],
            top_k=cfg.num_experts_per_tok,
            impl=_kernel_impl(cfg.use_grouped_matmul))
    else:
        routed, aux = moe_ffn(
            x, lp["router"], ex["w_gate"], ex["w_up"], ex["w_down"],
            top_k=cfg.num_experts_per_tok,
            capacity_factor=cfg.capacity_factor)
    sh = lp["shared"]
    shared = (F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])) @ sh["w_down"]
    shared = torch.sigmoid(x @ sh["gate"]) * shared
    return h + routed + shared, aux


def _check_impl(cfg: Qwen2MoeConfig) -> None:
    if cfg.moe_impl not in ("einsum", "dropless"):
        raise ValueError(f"moe_impl must be 'einsum' or 'dropless', "
                         f"got {cfg.moe_impl!r}")


def _sharded(mesh) -> bool:
    return any(mesh.degree(a) > 1 for a in ("dp", "ep", "tp"))


def _use_dropless(cfg: Qwen2MoeConfig, mesh) -> bool:
    """The JAX rule: dropless engages only where nothing it touches is
    sharded (no dp, ep or tp above 1); elsewhere the einsum path runs."""
    return cfg.moe_impl == "dropless" and (mesh is None
                                           or not _sharded(mesh))


def _check_mesh(cfg: Qwen2MoeConfig, mesh) -> None:
    from ..parallel.mesh import HybridMesh
    if not isinstance(mesh, HybridMesh):
        raise TypeError(f"mesh must be a parallel.HybridMesh "
                        f"(init_hybrid_mesh), got {type(mesh).__name__}")
    _check_impl(cfg)
    if mesh.pp_degree > 1 or mesh.cp_degree > 1:
        raise NotImplementedError(
            f"Qwen2-MoE trains over dp x ep x tp; pp={mesh.pp_degree} and "
            f"cp={mesh.cp_degree} must be 1 (the JAX specs name neither "
            f"axis, so JAX replicates the model over them)")
    ep, tp = mesh.ep_degree, mesh.tp_degree
    bad = {k: (n, d) for k, n, d in (
        ("experts", cfg.num_experts, ep),
        ("moe_intermediate_size", cfg.moe_intermediate_size, tp),
        ("shared_expert_intermediate_size",
         cfg.shared_expert_intermediate_size, tp),
        ("heads", cfg.num_attention_heads, tp),
        ("kv_heads", cfg.num_key_value_heads, tp),
        ("vocab", cfg.vocab_size, tp)) if n % d}
    if bad:
        raise ValueError(
            "the mesh does not divide " + ", ".join(
                f"{k}={n} over {d}" for k, (n, d) in bad.items())
            + " (GSPMD would pad an uneven split; the port shards evenly)")
    if cfg.moe_impl == "dropless" and _sharded(mesh) and \
            _kernel_impl(cfg.use_grouped_matmul) == "kernel":
        raise ValueError(
            "use_grouped_matmul='kernel' on a mesh with dp, ep or tp above "
            "1: the grouped-matmul kernels run only on unsharded layouts, "
            "where moe_impl='dropless' engages (the einsum path runs here)")


def forward(params, tokens, cfg: Qwen2MoeConfig, mesh=None):
    """tokens ``[B, T]`` -> (logits ``[B, T, V]`` in ``cfg.dtype``, the
    summed f32 aux loss), per-layer remat as ``cfg.remat`` says. With
    ``mesh`` (a dp x ep x tp ``HybridMesh``): ``params`` are this rank's
    shards, ``tokens`` its dp rows, the logits ``[B/dp, T, V/tp]`` its
    vocab shard's and the aux loss the global batch's (``_mesh_logits``).
    """
    _check_impl(cfg)
    if mesh is not None:
        _check_mesh(cfg, mesh)
        return _mesh_logits(params, tokens, cfg, mesh)
    use_dropless = cfg.moe_impl == "dropless"
    B, T = tokens.shape
    h = params["embed"].to(cfg.dtype)[tokens.long()]
    positions = torch.arange(T, device=h.device).expand(B, T)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.num_hidden_layers):
        lp = _layer(params, i)
        if cfg.remat:
            # only each layer's input is kept for the backward, which
            # recomputes the layer first
            h, a = checkpoint(decoder_layer, lp, h, cfg, positions,
                              use_dropless, use_reentrant=False)
        else:
            h, a = decoder_layer(lp, h, cfg, positions, use_dropless)
        aux = aux + a
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    return h @ params["lm_head"], aux


def loss_fn(params, batch, cfg: Qwen2MoeConfig, mesh=None):
    """Mean next-token NLL of the f32 log-softmax, plus
    ``router_aux_loss_coef`` times the summed aux loss. With
    ``moe_impl="dropless"``, ``jit.to_static`` captures it whole (gmm
    and tgmm one operator node each; ``m_pad`` is a Python int of the
    shapes), as ``llama.loss_fn``. With ``mesh``: the mean NLL over this
    rank's dp rows (the vocab-parallel cross entropy at tp > 1) plus the
    global aux term, the same on every ep and tp rank of those rows; the
    mesh step averages it over dp."""
    if mesh is not None:
        _check_mesh(cfg, mesh)
        return _mesh_loss(params, batch, cfg, mesh)
    logits, aux = forward(params, batch["tokens"], cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return nll.mean() + cfg.router_aux_loss_coef * aux


def make_train_step(cfg: Qwen2MoeConfig, device=None, optimizer=None,
                    mesh=None):
    """The train step (forward, backward, AdamW), as
    ``llama.make_train_step``: ``(step_fn, init_fn)``, ``init_fn`` from a
    ``torch.Generator`` or a params dict, ``step_fn(state, batch)``
    updating the state in place and returning ``(state, loss)``. The
    optimizer defaults to the JAX one, ``adamw(3e-4, b1 0.9, b2 0.95,
    weight_decay 0.1)``. With ``mesh`` (``init_hybrid_mesh(dp=, ep=,
    tp=)``) see ``_mesh_trainer``: the global batch in, the global mean
    loss out; no ZeRO stage, as in the JAX step."""
    if mesh is not None:
        return _mesh_trainer(cfg, mesh, device, optimizer)
    return llama.one_device_trainer(cfg, init_params, loss_fn, device,
                                    optimizer)


def make_batch(cfg: Qwen2MoeConfig, batch_size: int, seq_len: int,
               device=None, generator: Optional[torch.Generator] = None,
               mesh=None):
    """``llama.make_batch``'s synthetic batch (tokens and next-token
    labels, int32). With ``mesh`` it is still the global batch, as the
    mesh step takes it; B must divide over dp and T over tp (the stream
    is sequence-sharded)."""
    if mesh is not None:
        dp, tp = mesh.dp_degree, mesh.tp_degree
        if batch_size % dp or seq_len % tp:
            raise ValueError(f"batch [{batch_size}, {seq_len}] does not "
                             f"split over dp={dp} rows and tp={tp} "
                             f"sequence parts")
    return llama.make_batch(cfg, batch_size, seq_len, device=device,
                            generator=generator)


# ---------------------------------------------------------------------------
# parallel training: dp x ep x tp over torch.distributed, one process a
# rank (rows over dp, experts over ep, Megatron tp with sequence
# parallelism around attention and the MoE FFN)
# ---------------------------------------------------------------------------

def shard_params(params, cfg: Qwen2MoeConfig, mesh, device=None) -> Dict:
    """The rank's local shards, by ``param_specs``, of the global params
    (stacked layers: ``init_params`` or ``params_from_jax`` output), as
    new contiguous tensors on ``device`` (default: where they are)."""
    def conv(x, sp):
        out = llama._shard(x.detach(), sp, mesh).clone()
        return out if device is None else out.to(device)

    return llama._map_trees(conv, params, param_specs(cfg))


def _spec_tree(params, cfg: Qwen2MoeConfig) -> Dict:
    """``param_specs`` in the layout of ``params`` (stacked layers, or the
    trainer's list of per-layer dicts)."""
    specs = param_specs(cfg)
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        one = llama._map_trees(llama._layer_spec, specs["layers"])
        specs = dict(specs, layers=[one for _ in layers])
    return specs


def gather_params(state_or_params, cfg: Qwen2MoeConfig, mesh) -> Dict:
    """The global params as numpy in the JAX pytree layout
    (``llama.params_to_numpy``), from a mesh step's state or from
    rank-local params (stacked or per layer, or a gradient tree of that
    layout). A collective: every rank of the mesh calls it, and every
    rank gets the whole."""
    from ..distributed.communication import all_gather_cat
    src = state_or_params
    params = src["params"] if "params" in src and "opt" in src else src

    def whole(x, sp):
        x = x.detach()
        for dim, ax in enumerate(sp):
            if ax is not None and mesh.degree(ax) > 1:
                x = all_gather_cat(x.contiguous(), dim, mesh.group(ax))
        return x

    return llama.params_to_numpy(
        llama._map_trees(whole, params, _spec_tree(params, cfg)))


class _GatherPair(torch.autograd.Function):
    """The sequence-sharded stream all-gathered over tp once, as two
    outputs of one value with two backward rules: the first for
    column-parallel consumers (their tp-partial gradients
    reduce-scattered, summing the shards), the second for branches every
    tp rank computes whole (the router, the shared expert's gate: the
    rank takes its sequence part of the gradient, which would otherwise
    count tp times)."""

    @staticmethod
    def forward(ctx, x, g):
        from ..distributed.communication import all_gather_cat
        ctx.g = g
        full = all_gather_cat(x.contiguous(), 1, g)
        return full, full.clone()

    @staticmethod
    def backward(ctx, ct_partial, ct_whole):
        from ..distributed.communication import (rank_part,
                                                 reduce_scatter_dim)
        out = None
        if ct_partial is not None:
            out = reduce_scatter_dim(ct_partial, 1, ctx.g)
        if ct_whole is not None:
            part = rank_part(ct_whole, 1, ctx.g)
            out = part.contiguous() if out is None else out + part
        return out, None


def _moe_half(lp, h, cfg: Qwen2MoeConfig, mesh, use_dropless: bool):
    """The MoE FFN half of a mesh block on the sequence-sharded stream
    ``[B', T/tp, D]``: norm (local rows) -> all-gather -> routed experts
    (``moe_ffn_sharded``: global gating over dp, this rank's experts on
    its F shard, summed over ep) plus the gated shared expert
    (column-/row-parallel, its gate replicated) -> one reduce-scatter
    over tp, added to the stream. Returns ``(h, aux)``."""
    from ..distributed.sequence_parallel import reduce_scatter_sequence
    from ..parallel.mp_ops import identity_fwd_psum_bwd
    g = mesh.group("tp")
    x = llama._sp_norm(cfg, None, h, lp["mlp_norm"], mesh)
    if g.nranks > 1:
        x, xr = _GatherPair.apply(x, g)
    else:
        xr = x
    ex, sh = lp["experts"], lp["shared"]
    if use_dropless:
        routed, aux = moe_ffn_dropless(
            x, lp["router"], ex["w_gate"], ex["w_up"], ex["w_down"],
            top_k=cfg.num_experts_per_tok,
            impl=_kernel_impl(cfg.use_grouped_matmul))
    else:
        routed, aux = moe_ffn_sharded(
            x, lp["router"], ex["w_gate"], ex["w_up"], ex["w_down"],
            top_k=cfg.num_experts_per_tok,
            capacity_factor=cfg.capacity_factor,
            dp_group=mesh.group("dp"), ep_group=mesh.group("ep"),
            tp_group=g, x_router=xr)
    shared = (F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])) @ sh["w_down"]
    # the gate multiplies tp-partial products: its gradient is summed
    # over tp before the replicated branch takes it
    gate = identity_fwd_psum_bwd(torch.sigmoid(xr @ sh["gate"]), g)
    return h + reduce_scatter_sequence(routed + gate * shared, g), aux


def _mesh_layer(lp, h, cfg: Qwen2MoeConfig, mesh, positions,
                use_dropless: bool):
    """One block on this rank's stream: Llama's sequence-parallel
    attention half (``llama._sp_attention``, the plain rmsnorm and rope
    as in the JAX block) and ``_moe_half``."""
    h = llama._sp_attention(lp, h, cfg, mesh, positions)
    return _moe_half(lp, h, cfg, mesh, use_dropless)


def _mesh_logits(params, tokens, cfg: Qwen2MoeConfig, mesh):
    """This rank's rows ``[B/dp, T]`` -> (logits ``[B/dp, T, V/tp]`` of
    its vocab shard, the global aux loss): ``llama._mesh_embed`` (the
    vocab-parallel lookup into sequence parts), the blocks (checkpointed
    under ``cfg.remat`` while autograd records),
    ``llama._mesh_head_logits``."""
    h = llama._mesh_embed(params["embed"], tokens, cfg, mesh)
    B, T = tokens.shape
    positions = torch.arange(T, device=h.device).expand(B, T)
    use_dropless = _use_dropless(cfg, mesh)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.num_hidden_layers):
        args = (_layer(params, i), h, cfg, mesh, positions, use_dropless)
        if cfg.remat and torch.is_grad_enabled():
            h, a = checkpoint(_mesh_layer, *args, use_reentrant=False)
        else:
            h, a = _mesh_layer(*args)
        aux = aux + a
    return llama._mesh_head_logits(params["final_norm"], params["lm_head"],
                                   h, cfg, mesh), aux


def _mesh_loss(params, batch, cfg: Qwen2MoeConfig, mesh):
    logits, aux = _mesh_logits(params, batch["tokens"], cfg, mesh)
    return llama._mesh_nll(logits, batch["labels"], mesh) \
        + cfg.router_aux_loss_coef * aux


def _mesh_trainer(cfg: Qwen2MoeConfig, mesh, device, optimizer):
    """``(step_fn, init_fn)`` of the dp x ep x tp step on this rank.

    ``init_fn(source)``: a ``torch.Generator`` draws the params as
    ``init_params`` does (every rank alike), each leaf cut to this rank's
    shard as it is drawn; a params dict is sharded (``shard_params``).
    The trainer's leaves are per layer (``llama._train_params``).

    ``step_fn(state, batch)`` takes the GLOBAL batch, reads this rank's dp
    rows (by its dp index: ep and tp peers read the same rows), and
    returns the global mean loss. Gradients of the rank's loss (its rows'
    mean plus the global aux term) are all-reduced over dp and scaled by
    1/dp, then AdamW updates each leaf in place. Nothing is reduced over
    ep or tp here: the blocks' f / g pairs leave every replicated leaf's
    gradient whole and equal on its ep and tp peers, so those leaves stay
    bitwise equal across ep."""
    from ..distributed import communication as C
    _check_mesh(cfg, mesh)
    dev = resolve_device(device)
    opt = llama.default_train_optimizer() if optimizer is None \
        else optimizer
    dp, dp_g = mesh.dp_degree, mesh.group("dp")

    def init_fn(source):
        if isinstance(source, torch.Generator):
            params = init_params(cfg, source, dev, mesh=mesh)
        else:
            params = shard_params(source, cfg, mesh)
        params = llama._train_params(params, dev)
        return {"params": params, "opt": opt.init(params), "step": 0}

    def rows(batch):
        r, n = mesh.axis_index("dp"), batch["tokens"].shape[0] // dp
        return {k: v[r * n:(r + 1) * n].to(dev) for k, v in batch.items()}

    def step_fn(state, batch):
        value = _mesh_loss(state["params"], rows(batch), cfg, mesh)
        value.backward()
        if dp > 1:
            for p in llama._tree_leaves(state["params"]):
                C.all_reduce(p.grad, C.ReduceOp.SUM, dp_g)
                p.grad.mul_(float(torch.tensor(1.0 / dp, dtype=p.dtype)))
        opt.update_(state["params"], state["opt"])
        loss = value.detach().clone()
        if dp > 1:
            C.all_reduce(loss, C.ReduceOp.AVG, dp_g)
        state["step"] += 1
        return state, loss

    return step_fn, init_fn


# ---------------------------------------------------------------------------
# decode: dense KV cache + generate
# ---------------------------------------------------------------------------

def _dense_w(w, dtype):
    """A dense view of an expert weight that may be an ``Int8Weight``:
    the einsum MoE FFN takes whole expert tensors, so quantized experts
    are dequantized (``Int8Weight.dequant``, JAX's bits) for each call."""
    return w.dequant(dtype) if isinstance(w, Int8Weight) else w


def _decode_block(lp, h, positions, cfg: Qwen2MoeConfig, attn_fn):
    """The block of every cached-decode and serving path, with the
    signature of ``llama._block``: rms_norm -> QKV -> rope -> ``attn_fn``
    -> o-proj + residual -> rms_norm -> the routed MoE FFN, DROP-FREE
    (capacity factor E / top_k makes the capacity the cohort size), plus
    the gated shared expert, + residual. Projections through ``_mm``
    (dense or ``Int8Weight``); the routed experts through ``_dense_w``."""
    B, T, _ = h.shape
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    x = rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps)
    q = _mm(x, lp["wq"]).reshape(B, T, H, Dh)
    k = _mm(x, lp["wk"]).reshape(B, T, Hkv, Dh)
    v = _mm(x, lp["wv"]).reshape(B, T, Hkv, Dh)
    q, k = rope(q, k, positions, cfg.rope_theta, Dh)
    o = attn_fn(q, k, v)
    h = h + _mm(o.reshape(B, T, H * Dh), lp["wo"])

    x = rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
    ex = lp["experts"]
    routed, _ = moe_ffn(
        x, lp["router"], _dense_w(ex["w_gate"], cfg.dtype),
        _dense_w(ex["w_up"], cfg.dtype), _dense_w(ex["w_down"], cfg.dtype),
        top_k=cfg.num_experts_per_tok,
        capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    sh = lp["shared"]
    shared = _mm(F.silu(_mm(x, sh["w_gate"])) * _mm(x, sh["w_up"]),
                 sh["w_down"])
    shared = torch.sigmoid(x @ sh["gate"]) * shared
    return h + routed + shared


@torch.no_grad()
def forward_with_cache(params, tokens, cache, pos0: int,
                       cfg: Qwen2MoeConfig):
    """tokens ``[B, T]`` at positions pos0 .. pos0+T-1 -> (f32 logits of
    the LAST position ``[B, V]``, cache), the cache updated in place.
    pos0 == 0 is a prompt: causal flash attention over the fresh keys
    (``use_flash_attention`` picks kernel or plain version); otherwise
    plain attention over the cache (``llama._cached_attention``)."""
    impl = _kernel_impl(cfg.use_flash_attention)
    return llama._forward_with_cache(
        params, tokens, cache, pos0, cfg, _decode_block,
        lambda q, k, v: flash_attention(q, k, v, causal=True, impl=impl))


def generate(params, prompt, cfg: Qwen2MoeConfig, max_new_tokens: int,
             *, temperature: float = 0.0, top_p: float = 1.0,
             top_k: int = 0, key=None, eos_token_id: Optional[int] = None):
    """Autoregressive MoE decode with a dense KV cache, on the params'
    device: ``llama.generate``'s contract (the same split chain of keys,
    EOS latch; returns int32 prompt + continuation), drop-free routing."""
    return llama._decode_loop(
        lambda p, t, c, pos: forward_with_cache(p, t, c, pos, cfg),
        lambda B, n, dev: init_kv_cache(cfg, B, n, dev),
        params, prompt, max_new_tokens, temperature, top_p, top_k, key,
        eos_token_id)


# ---------------------------------------------------------------------------
# serving: the Llama serving functions with this model's block
# ---------------------------------------------------------------------------

def serving_prefill(params, tokens, length, table, k_pages, v_pages, cfg,
                    attn_impl: str = "auto"):
    """``llama.serving_prefill`` with the MoE block."""
    return llama.serving_prefill(params, tokens, length, table, k_pages,
                                 v_pages, cfg, attn_impl=attn_impl,
                                 _block_fn=_decode_block)


def serving_prefill_chunk(params, tokens, length, table, k_pages, v_pages,
                          cfg, prefix_pages: int, attn_impl: str = "auto"):
    """``llama.serving_prefill_chunk`` with the MoE block."""
    return llama.serving_prefill_chunk(
        params, tokens, length, table, k_pages, v_pages, cfg, prefix_pages,
        attn_impl=attn_impl, _block_fn=_decode_block)


def serving_decode_step(params, tok, lengths, tables, k_pages, v_pages,
                        cfg, attn_impl: str = "auto"):
    """``llama.serving_decode_step`` with the MoE block."""
    return llama.serving_decode_step(params, tok, lengths, tables, k_pages,
                                     v_pages, cfg, attn_impl=attn_impl,
                                     _block_fn=_decode_block)


def serving_decode_block(params, tok, lengths, tables, k_pages, v_pages,
                         cfg, num_steps: int, attn_impl: str = "auto"):
    """``llama.serving_decode_block`` with the MoE block."""
    return llama.serving_decode_block(
        params, tok, lengths, tables, k_pages, v_pages, cfg, num_steps,
        attn_impl=attn_impl, _block_fn=_decode_block)


def serving_tick(params, tokens, meta, k_pages, v_pages, cfg,
                 decode_tail: int = 0, spec_k: int = 0,
                 attn_impl: str = "auto"):
    """``llama.serving_tick`` (decode tail, speculative verify, in-tick
    sampling) with the MoE block."""
    return llama.serving_tick(params, tokens, meta, k_pages, v_pages, cfg,
                              decode_tail=decode_tail, spec_k=spec_k,
                              attn_impl=attn_impl, _block_fn=_decode_block)


def serving_tick_block(params, tok, lengths, tables, k_pages, v_pages,
                       cfg, num_steps: int, attn_impl: str = "auto",
                       sampling=None):
    """``llama.serving_tick_block`` with the MoE block."""
    return llama.serving_tick_block(
        params, tok, lengths, tables, k_pages, v_pages, cfg, num_steps,
        attn_impl=attn_impl, sampling=sampling, _block_fn=_decode_block)
