"""Grouped (per-expert) matmul for dropless MoE: the hand-written Hopper
kernels' wrappers, their plain PyTorch versions, and the dropless glue.

Port of ``paddle_tpu/ops/pallas/grouped_matmul.py``: ``gmm`` (:148, with
``_gmm_fwd`` / ``_gmm_bwd``; the TPU kernel ``_gmm_kernel`` :60), the
weight-gradient kernel ``_tgmm_call`` (:117, ``_tgmm_kernel`` :98),
``sort_and_pad_by_expert`` (:220) and ``moe_mlp_dropless`` (:266).

Layout (the JAX package's): lhs ``[M, K]`` token-sorted rows, M a
multiple of ``tile_m``; row tile i (rows ``i * tile_m ...``) belongs to
expert ``tile_expert[i]`` (int32 ``[M // tile_m]``); rhs ``[E, K, N]``.

* ``gmm(lhs, rhs, tile_expert, tile_m)`` -> ``[M, N]`` in lhs's dtype:
  ``lhs[tile i] @ rhs[tile_expert[i]]``, f32 sums (f64 for f64 inputs in
  the plain version), one cast. ``trans=True`` reads rhs ``[E, N, K]`` as
  its transpose: the backward's dlhs uses it instead of the JAX
  package's ``swapaxes`` copy of the weight. An autograd Function whose
  backward is ``_gmm_bwd``'s: the cotangent cast to lhs's dtype, dlhs =
  ``gmm`` on the transposed weight, drhs = ``tgmm`` cast to rhs's dtype,
  no gradient for ``tile_expert``.
* ``tgmm(lhs, g, tile_expert, num_experts, tile_m)`` -> ``[E, K, N]`` in
  lhs's dtype: for each expert the f32 sum over its tiles, in ascending
  index, of ``lhs[tile]^T @ g[tile]``, rounded once; 0 for an expert that
  owns no tile.

Both bf16 kernels (``csrc/grouped_matmul.cu``) run on the shared wgmma +
TMA mainloop of ``csrc/gemm_sm90.cuh``, persistent blocks walking a list
of items. gmm's items are (128-row block, 128-column tile) pairs,
ordered expert by expert so that an expert's row blocks read each
weight panel together; its dlhs reads the weight as a K-major operand.
tgmm's are (expert, 128 x 256 output tile), expert-major, each summing
over its expert's tiles in ascending index. Both build their order from
``tile_expert`` on the device (no host sync), need no sorted
``tile_expert``, have no atomics and give the same bits from run to
run.

Like the JAX ``gmm``, ``gmm`` raises ``ValueError`` for a decreasing
``tile_expert`` (the TPU weight-gradient kernel's precondition), but only
for CPU tensors: on the card the check would wait for the device. The
check sits in the operator's CPU body, so a traced gmm holds no
data-dependent branch. The port's kernels and plain versions themselves
take any tile order.

Both are PyTorch operators, ``paddle_tpu::gmm`` and ``paddle_tpu::tgmm``
(``_op.py``), called while a graph is traced; gmm carries
``register_autograd`` with ``_gmm_bwd``'s formula (dlhs the gmm operator
with ``not trans``, drhs the tgmm operator), which an eager call runs
directly (``_GMM``). The
kernels take ``tile_m`` a multiple of 128 and K, N multiples of 8, in
float32 or bfloat16, and raise on anything else. The JAX package's
``tile_n`` and its VMEM fit (``_fit_tile_n``) and autotune lookup have no
counterpart: the kernels tile the columns themselves.

impl: ``"auto"`` — the kernels for CUDA tensors, the plain versions for
CPU tensors; ``"kernel"`` — the kernels, raising on anything they cannot
take; ``"reference"`` — the plain versions on any device. ``gmm.launches``
counts gmm kernel launches (forward and dlhs), ``tgmm.launches`` tgmm
launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._op import acc_dtype, check_impl, direct_function, traced, use_kernel

__all__ = ["gmm", "tgmm", "gmm_reference", "tgmm_reference",
           "sort_and_pad_by_expert", "moe_mlp_dropless"]

_KERNEL = "grouped_matmul"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_TILE_M = 128          # the kernels' row tile: tile_m % 128 == 0


def gmm_reference(lhs, rhs, tile_expert, tile_m: int = 128,
                  trans: bool = False):
    """Plain ``gmm``: each row tile times its expert's weight (``rhs[e]``,
    or ``rhs[e]^T`` with ``trans``) in f32, one cast to lhs's dtype."""
    M, K = lhs.shape
    acc = acc_dtype(lhs.dtype)
    w = rhs.transpose(1, 2) if trans else rhs
    n = M // tile_m
    out = torch.bmm(lhs.reshape(n, tile_m, K).to(acc),
                    w[tile_expert.long()].to(acc))
    return out.reshape(M, w.shape[2]).to(lhs.dtype)


def tgmm_reference(lhs, g, tile_expert, num_experts: int,
                   tile_m: int = 128):
    """Plain ``tgmm`` in f32 (f64 for f64 inputs), uncast: each tile's
    ``lhs^T @ g``, added into its expert's slot in ascending tile order
    (``index_add_``); experts with no tile stay 0."""
    M, K = lhs.shape
    N = g.shape[1]
    acc = acc_dtype(lhs.dtype)
    n = M // tile_m
    per_tile = torch.bmm(lhs.reshape(n, tile_m, K).transpose(1, 2).to(acc),
                         g.reshape(n, tile_m, N).to(acc))
    out = torch.zeros((num_experts, K, N), dtype=acc, device=lhs.device)
    return out.index_add_(0, tile_expert.long(), per_tile)


def _lib():
    lib = _build.load(_KERNEL)
    if lib.paddle_gmm.argtypes is None:
        lib.paddle_gmm.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.paddle_gmm.restype = ctypes.c_int
        lib.paddle_tgmm.argtypes = ([ctypes.c_void_p] * 4
                                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.paddle_tgmm.restype = ctypes.c_int
    return lib


def _kernel_inputs(what: str, a, b, tile_expert, tile_m: int):
    """Device, dtype, layout and shape checks shared by both kernels;
    returns the contiguous operands."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"the {what} kernel takes CUDA tensors, got {dev}")
    for name, t in (("second operand", b), ("tile_expert", tile_expert)):
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, lhs on {dev}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"{what}: operands must both be float32 or bfloat16, "
                        f"got {a.dtype}/{b.dtype}")
    if tile_expert.dtype != torch.int32:
        raise TypeError(f"{what}: tile_expert must be int32, got "
                        f"{tile_expert.dtype}")
    M = a.shape[0]
    if tile_m % KERNEL_TILE_M or M % tile_m or M == 0:
        raise ValueError(f"{what} kernel takes tile_m a multiple of "
                         f"{KERNEL_TILE_M} dividing M; got tile_m={tile_m}, "
                         f"M={M}")
    a, b, te = a.contiguous(), b.contiguous(), tile_expert.contiguous()
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{what}: operands must be 16-byte aligned")
    return a, b, te


def _raise(err: int, what: str, shape) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed (error {err}) for "
                           f"shape {shape}")


def _gmm_launch(lhs, rhs, tile_expert, tile_m: int, trans: bool):
    lhs, rhs, te = _kernel_inputs("gmm", lhs, rhs, tile_expert, tile_m)
    M, K = lhs.shape
    E = rhs.shape[0]
    N = rhs.shape[1] if trans else rhs.shape[2]
    if K % 8 or N % 8:
        raise ValueError(f"gmm kernel takes K and N multiples of 8 (16-byte "
                         f"copies); got K={K}, N={N}")
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    with torch.cuda.device(lhs.device):
        err = _lib().paddle_gmm(
            lhs.data_ptr(), rhs.data_ptr(), te.data_ptr(), out.data_ptr(),
            M, K, N, E, tile_m, int(trans), _DTYPE_CODE[lhs.dtype],
            torch.cuda.current_stream().cuda_stream)
    _raise(err, "gmm", (M, K, N, E))
    gmm.launches += 1
    return out


def _tgmm_launch(lhs, g, tile_expert, num_experts: int, tile_m: int):
    lhs, g, te = _kernel_inputs("tgmm", lhs, g, tile_expert, tile_m)
    M, K = lhs.shape
    N = g.shape[1]
    if K % 8 or N % 8:
        raise ValueError(f"tgmm kernel takes K and N multiples of 8 (16-byte "
                         f"copies); got K={K}, N={N}")
    out = torch.empty((num_experts, K, N), dtype=lhs.dtype,
                      device=lhs.device)
    with torch.cuda.device(lhs.device):
        err = _lib().paddle_tgmm(
            lhs.data_ptr(), g.data_ptr(), te.data_ptr(), out.data_ptr(),
            M, K, N, num_experts, tile_m, _DTYPE_CODE[lhs.dtype],
            torch.cuda.current_stream().cuda_stream)
    _raise(err, "tgmm", (M, K, N, num_experts))
    tgmm.launches += 1
    return out


def _check_tiles(M: int, tile_expert, tile_m: int) -> None:
    if tile_expert.dim() != 1 or M % tile_m or \
            tile_expert.shape[0] != M // tile_m:
        raise ValueError(f"tile_expert must be [M // tile_m] with M % tile_m "
                         f"== 0; got M={M}, tile_m={tile_m}, tile_expert "
                         f"{tuple(tile_expert.shape)}")


def _check_sorted(tile_expert) -> None:
    """The JAX ``gmm``'s precondition, checked for CPU tensors only (on
    the card the check would wait for the device)."""
    if not tile_expert.is_cuda and tile_expert.numel() > 1 and bool(
            (tile_expert[1:] < tile_expert[:-1]).any()):
        raise ValueError(
            "gmm: tile_expert must be non-decreasing (sorted by expert) "
            "for correct weight gradients; use sort_and_pad_by_expert")


def _gmm_run(lhs, rhs, tile_expert, tile_m: int, trans: bool, impl: str):
    if use_kernel(impl, lhs):
        return _gmm_launch(lhs, rhs, tile_expert, tile_m, trans)
    _check_sorted(tile_expert)
    return gmm_reference(lhs, rhs, tile_expert, tile_m, trans)


def _tgmm_run(lhs, g, tile_expert, num_experts: int, tile_m: int,
              impl: str):
    if use_kernel(impl, lhs):
        return _tgmm_launch(lhs, g, tile_expert, num_experts, tile_m)
    return tgmm_reference(lhs, g, tile_expert, num_experts,
                          tile_m).to(lhs.dtype)


@torch.library.custom_op("paddle_tpu::gmm", mutates_args=())
def _gmm_op(lhs: torch.Tensor, rhs: torch.Tensor, tile_expert: torch.Tensor,
            tile_m: int, trans: bool, impl: str) -> torch.Tensor:
    return _gmm_run(lhs, rhs, tile_expert, tile_m, trans, impl)


@_gmm_op.register_fake
def _(lhs, rhs, tile_expert, tile_m, trans, impl):
    return lhs.new_empty((lhs.shape[0], rhs.shape[1 if trans else 2]))


@torch.library.custom_op("paddle_tpu::tgmm", mutates_args=())
def _tgmm_op(lhs: torch.Tensor, g: torch.Tensor, tile_expert: torch.Tensor,
             num_experts: int, tile_m: int, impl: str) -> torch.Tensor:
    return _tgmm_run(lhs, g, tile_expert, num_experts, tile_m, impl)


@_tgmm_op.register_fake
def _(lhs, g, tile_expert, num_experts, tile_m, impl):
    return lhs.new_empty((num_experts, lhs.shape[1], g.shape[1]))


def _setup(ctx, inputs, output):
    lhs, rhs, tile_expert, tile_m, trans, impl = inputs
    ctx.save_for_backward(lhs, rhs, tile_expert)
    ctx.tile_m, ctx.trans, ctx.impl = tile_m, trans, impl


def _backward(gmm_fn, tgmm_fn, ctx, g):
    """``_gmm_bwd``'s: the cotangent cast to lhs's dtype, dlhs = gmm on
    the transposed weight, drhs = tgmm cast to rhs's dtype."""
    lhs, rhs, te = ctx.saved_tensors
    tm, trans, impl = ctx.tile_m, ctx.trans, ctx.impl
    g = g.to(lhs.dtype).contiguous()
    dlhs = drhs = None
    if ctx.needs_input_grad[0]:
        # g @ W_e^T: the same kernel reading the weight the other way
        dlhs = gmm_fn(g, rhs, te, tm, not trans, impl)
    if ctx.needs_input_grad[1]:
        a, b = (g, lhs) if trans else (lhs, g)
        drhs = tgmm_fn(a, b, te, rhs.shape[0], tm, impl).to(rhs.dtype)
    return dlhs, drhs, None, None, None, None


_gmm_op.register_autograd(
    lambda ctx, g: _backward(_gmm_op, _tgmm_op, ctx, g),
    setup_context=_setup)
_GMM = direct_function(
    "_GMM", _gmm_run, _setup,
    lambda ctx, g: _backward(_gmm_run, _tgmm_run, ctx, g))


def gmm(lhs, rhs, tile_expert, tile_m: int = 128, *, trans: bool = False,
        impl: str = "auto"):
    """Grouped matmul ``[M, K] x [E, K, N] -> [M, N]`` (module
    docstring); differentiable in lhs and rhs."""
    check_impl(impl)
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError(f"lhs [M, K] and rhs [E, K, N] expected, got "
                         f"{tuple(lhs.shape)} and {tuple(rhs.shape)}")
    k_axis = 2 if trans else 1
    if rhs.shape[k_axis] != lhs.shape[1]:
        raise ValueError(f"lhs K={lhs.shape[1]} does not match rhs "
                         f"{tuple(rhs.shape)} (trans={trans})")
    _check_tiles(lhs.shape[0], tile_expert, tile_m)
    fn = _gmm_op if traced() else _GMM.apply
    return fn(lhs, rhs, tile_expert, int(tile_m), bool(trans), impl)


gmm.launches = 0


def tgmm(lhs, g, tile_expert, num_experts: int, tile_m: int = 128,
         impl: str = "auto"):
    """Per-expert ``lhs^T @ g`` over each expert's row tiles ->
    ``[E, K, N]`` in lhs's dtype (module docstring)."""
    check_impl(impl)
    if lhs.dim() != 2 or g.dim() != 2 or lhs.shape[0] != g.shape[0]:
        raise ValueError(f"lhs [M, K] and g [M, N] expected, got "
                         f"{tuple(lhs.shape)} and {tuple(g.shape)}")
    _check_tiles(lhs.shape[0], tile_expert, tile_m)
    fn = _tgmm_op if traced() else _tgmm_run
    return fn(lhs, g, tile_expert, int(num_experts), int(tile_m), impl)


tgmm.launches = 0


# ---------------------------------------------------------------------------
# dropless MoE glue
# ---------------------------------------------------------------------------

def sort_and_pad_by_expert(expert_ids, num_experts: int, tile_m: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, int]:
    """Tile-aligned destination rows for a counting sort by expert (the
    JAX function's outputs, bit for bit).

    expert_ids: int ``[A]`` expert per (token, k) assignment. Returns
    ``(order, dest, tile_expert, m_pad)``: ``order`` the identity
    ``[A]``; ``dest[i]`` the row of assignment i in the padded
    ``[m_pad, ...]`` buffer (each expert's rows start at a tile_m-aligned
    offset, in assignment order); ``tile_expert`` int32
    ``[m_pad // tile_m]``, trailing all-padding tiles clipped to expert
    E - 1; ``m_pad`` = A rounded up to tiles plus E - 1 tiles of padding,
    a Python int that depends on (A, E, tile_m) only. Everything stays on
    expert_ids's device: no host sync.

    Like the JAX function this is a counting sort: the rank of an
    assignment within its expert is a cumsum over the one-hot, laid out
    ``[E, A]`` here so that each expert's scan runs along a contiguous
    row (on an H100 at A = 8192, E = 60: 0.09 ms, against 1.45 ms for
    the scan down the ``[A, E]`` layout's long axis and 2.3 ms of host
    time for a stable argsort)."""
    A = expert_ids.shape[0]
    E = num_experts
    dev = expert_ids.device
    m_pad = ((A + tile_m - 1) // tile_m + (E - 1)) * tile_m
    eids = expert_ids.long()
    order = torch.arange(A, dtype=torch.int32, device=dev)
    onehot = (torch.arange(E, device=dev)[:, None] == eids).to(torch.int32)
    incl = onehot.cumsum(1, dtype=torch.int32)                 # [E, A]
    counts = incl[:, -1]
    # stable rank of assignment i within its expert group
    rank = incl.gather(0, eids[None, :])[0] - 1
    padded = (counts + tile_m - 1) // tile_m * tile_m
    ends = padded.cumsum(0, dtype=torch.int32)
    dest = (ends - padded)[eids] + rank
    tile_starts = torch.arange(m_pad // tile_m, dtype=torch.int32,
                               device=dev) * tile_m
    tile_expert = torch.searchsorted(ends, tile_starts, right=True)
    tile_expert = tile_expert.clamp_max(E - 1).to(torch.int32)
    return order, dest.to(torch.int32), tile_expert, m_pad


def moe_mlp_dropless(x, expert_ids, combine_weights, w_gate, w_up, w_down,
                     *, tile_m: int = 128, impl: str = "auto"):
    """Dropless token-choice MoE FFN (SwiGLU experts) on the grouped
    matmul: x ``[S, D]``; expert_ids / combine_weights ``[S, k]``;
    w_gate / w_up ``[E, D, F]``; w_down ``[E, F, D]``. Returns ``[S, D]``.

    ``order`` is the identity and assignment i is token ``i // k``, so
    the glue is gathers and copies only, with no atomics forward or
    backward: each token is repeated k times (backward: a sum over k),
    copied to its unique padded row (``index_copy``; backward: a gather),
    and the k expert outputs are gathered back, scaled by their weights
    and summed over k. Rounding points: the SwiGLU product and the
    weighted outputs are rounded to the expert output's dtype; the sum
    over k accumulates in f32 and rounds once (the JAX package's
    scatter-add into the output buffer rounds after each add in bf16)."""
    S, D = x.shape
    k = expert_ids.shape[1]
    E = w_gate.shape[0]
    flat_e = expert_ids.reshape(-1).to(torch.int32)
    _, dest, tile_expert, m_pad = sort_and_pad_by_expert(flat_e, E, tile_m)
    dest = dest.long()
    xa = x[:, None, :].expand(S, k, D).reshape(S * k, D)
    xs = x.new_zeros((m_pad, D)).index_copy(0, dest, xa)
    h = (F.silu(gmm(xs, w_gate, tile_expert, tile_m, impl=impl))
         * gmm(xs, w_up, tile_expert, tile_m, impl=impl))
    ys = gmm(h.to(x.dtype), w_down, tile_expert, tile_m, impl=impl)
    w = combine_weights.reshape(-1).to(ys.dtype)
    return (ys.index_select(0, dest) * w[:, None]).view(S, k, D).sum(1)
